"""Transducer joint network.  Counterpart of
wenet_tpu/models/transducer/joint.py, with the reference wenet
state_dict keys (the HAT heads are the reference's Sequentials, whose
Linear is `blank_pred.2` / `token_pred.2`)."""

import torch
from torch import nn
import torch.nn.functional as F

from wenet_tpu_torch.models.transformer.activations import get_activation


class _Activation(nn.Module):

    def __init__(self, name: str):
        super().__init__()
        self.fn = get_activation(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fn(x)


class TransducerJoint(nn.Module):

    def __init__(self, vocab_size: int, enc_output_size: int,
                 pred_output_size: int, join_dim: int,
                 prejoin_linear: bool = True, postjoin_linear: bool = False,
                 joint_mode: str = 'add', activation: str = 'tanh',
                 hat_joint: bool = False, dropout_rate: float = 0.1,
                 hat_activation: str = 'tanh'):
        super().__init__()
        if joint_mode != 'add':
            raise NotImplementedError(f'joint_mode={joint_mode!r}: only '
                                      "'add', as the JAX package")
        if not prejoin_linear and not postjoin_linear and not (
                enc_output_size == pred_output_size == join_dim):
            raise ValueError('without pre- or post-join linears the '
                             'encoder, predictor and join widths agree')
        self.prejoin_linear = prejoin_linear
        self.postjoin_linear = postjoin_linear
        self.hat_joint = hat_joint
        self.activation = get_activation(activation)
        if prejoin_linear:
            self.enc_ffn = nn.Linear(enc_output_size, join_dim)
            self.pred_ffn = nn.Linear(pred_output_size, join_dim)
        if postjoin_linear:
            self.post_ffn = nn.Linear(
                join_dim if prejoin_linear else enc_output_size, join_dim)
        if not hat_joint:
            self.ffn_out = nn.Linear(join_dim, vocab_size)
        else:
            self.blank_pred = nn.Sequential(
                nn.Tanh(), nn.Dropout(dropout_rate), nn.Linear(join_dim, 1),
                nn.LogSigmoid())
            self.token_pred = nn.Sequential(
                _Activation(hat_activation), nn.Dropout(dropout_rate),
                nn.Linear(join_dim, vocab_size - 1))

    def project_enc(self, enc_out: torch.Tensor) -> torch.Tensor:
        """The encoder's pre-join linear (identity without one): a search
        projects the frames once and calls forward with
        pre_project=False."""
        return self.enc_ffn(enc_out) if self.prejoin_linear else enc_out

    def project_pred(self, pred_out: torch.Tensor) -> torch.Tensor:
        return self.pred_ffn(pred_out) if self.prejoin_linear else pred_out

    def forward(self, enc_out: torch.Tensor, pred_out: torch.Tensor,
                pre_project: bool = True) -> torch.Tensor:
        """enc_out (B, T, E) or (B, T, 1, D), pred_out (B, U, P) ->
        (B, T, U, V); with hat_joint the log-probs of the factorization."""
        if pre_project:
            enc_out = self.project_enc(enc_out)
            pred_out = self.project_pred(pred_out)
        if enc_out.dim() != 4:
            enc_out = enc_out[:, :, None, :]
        if pred_out.dim() != 4:
            pred_out = pred_out[:, None, :, :]
        out = enc_out + pred_out
        if self.postjoin_linear:
            out = self.post_ffn(out)
        if not self.hat_joint:
            return self.ffn_out(self.activation(out))
        blank_logp = self.blank_pred(out)
        scale_logp = (1 - blank_logp.exp()).clamp(min=1e-6)
        label_logp = F.log_softmax(self.token_pred(out), dim=-1)
        return torch.cat([blank_logp, scale_logp.log() + label_logp],
                         dim=-1)


JOINT_CLASSES = {'transducer_joint': TransducerJoint}
