"""Transducer predictors.  Counterpart of
wenet_tpu/models/transducer/predictor.py, with the reference wenet
state_dict keys (the LSTM is `torch.nn.LSTM`: `rnn.weight_ih_l{k}` etc.,
[i, f, g, o] gates, the layout the JAX package's TorchLSTM keeps).

Every predictor has
  forward(input (B, U), cache=None) -> (B, U, P)       (training)
  init_state(batch_size, device, dtype) -> state tuple
  select_state(new, old, keep_new (B,) bool) -> per-row select
  forward_step(input (B, 1), padding (B, 1), state) -> ((B, 1, P), state)
The RNN state keeps the batch on axis 1, (L, B, H) as torch's LSTM; the
others on axis 0."""

from typing import Tuple

import torch
from torch import nn

from wenet_tpu_torch.models.transformer.activations import get_activation


class RNNPredictor(nn.Module):

    state_batch_axis = 1

    def __init__(self, voca_size: int, embed_size: int, output_size: int,
                 embed_dropout: float, hidden_size: int, num_layers: int,
                 bias: bool = True, rnn_type: str = 'lstm',
                 dropout: float = 0.1):
        super().__init__()
        if rnn_type != 'lstm':
            raise NotImplementedError(f'rnn_type={rnn_type!r}: only the '
                                      'lstm predictor, as the JAX package')
        self.num_layers, self.hidden_size = num_layers, hidden_size
        self.embed = nn.Embedding(voca_size, embed_size)
        self.dropout = nn.Dropout(embed_dropout)
        self.rnn = nn.LSTM(embed_size, hidden_size, num_layers, bias=bias,
                           batch_first=True, dropout=dropout)
        self.projection = nn.Linear(hidden_size, output_size)

    def init_state(self, batch_size: int, device=None, dtype=None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        z = torch.zeros(self.num_layers, batch_size, self.hidden_size,
                        device=device, dtype=dtype)
        return (z, z)

    def forward(self, input: torch.Tensor, cache=None) -> torch.Tensor:
        emb = self.dropout(self.embed(input))
        state = cache if cache is not None else self.init_state(
            input.shape[0], emb.device, emb.dtype)
        out, _ = self.rnn(emb, state)
        return self.projection(out)

    def select_state(self, new_state, old_state, keep_new: torch.Tensor):
        m = keep_new[None, :, None]
        return tuple(torch.where(m, n, o)
                     for n, o in zip(new_state, old_state))

    def forward_step(self, input: torch.Tensor, padding: torch.Tensor,
                     cache) -> Tuple[torch.Tensor, Tuple]:
        """input (B, 1); padding (B, 1), 1 = pad (the row keeps its
        state)."""
        out, (m, c) = self.rnn(self.embed(input), cache)
        keep = 1.0 - padding.reshape(1, -1, 1)
        m = cache[0] * (1 - keep) + m * keep
        c = cache[1] * (1 - keep) + c * keep
        return self.projection(out), (m, c)


class _HistoryPredictor(nn.Module):
    """The embedding and conv predictors' state: the last history_size
    embeddings, (B, history_size, E)."""

    state_batch_axis = 0

    def init_state(self, batch_size: int, device=None, dtype=None):
        return (torch.zeros(batch_size, self.context_size - 1,
                            self.embed_size, device=device, dtype=dtype),)

    def select_state(self, new_state, old_state, keep_new: torch.Tensor):
        m = keep_new[:, None, None]
        return tuple(torch.where(m, n, o)
                     for n, o in zip(new_state, old_state))

    def _context(self, input, cache):
        """[history, embeddings of input] -> (B, C - 1 + L, E)."""
        emb = self.embed_dropout(self.embed(input))
        history = cache[0] if cache is not None else self.init_state(
            input.shape[0], emb.device, emb.dtype)[0]
        return torch.cat([history, emb], dim=1)

    def forward(self, input: torch.Tensor, cache=None) -> torch.Tensor:
        return self._output(self._context(input, cache))

    def forward_step(self, input: torch.Tensor, padding: torch.Tensor,
                     cache) -> Tuple[torch.Tensor, Tuple]:
        context = torch.cat([cache[0], self.embed(input)], dim=1)
        return self._output(context), (context[:, 1:],)


class EmbeddingPredictor(_HistoryPredictor):
    """Stateless n-gram attention over the last history_size + 1
    embeddings."""

    def __init__(self, voca_size: int, embed_size: int, output_size: int,
                 embed_dropout: float, n_head: int, history_size: int = 2,
                 activation: str = 'swish', bias: bool = False,
                 layer_norm_epsilon: float = 1e-5):
        super().__init__()
        if output_size != embed_size:
            raise ValueError('EmbeddingPredictor needs output_size == '
                             'embed_size')
        self.n_head, self.embed_size = n_head, embed_size
        self.context_size = history_size + 1
        # a Linear whose weight (H, C*E) is read directly, never called
        self.pos_embed = nn.Linear(self.context_size * embed_size, n_head,
                                   bias=False)
        self.embed = nn.Embedding(voca_size, embed_size)
        self.embed_dropout = nn.Dropout(embed_dropout)
        self.ffn = nn.Linear(embed_size, embed_size)
        self.norm = nn.LayerNorm(embed_size, eps=layer_norm_epsilon)
        self.activation = get_activation(activation)

    def _output(self, x: torch.Tensor) -> torch.Tensor:
        C, H, E = self.context_size, self.n_head, self.embed_size
        windows = x.unfold(1, C, 1).transpose(2, 3)  # (B, L, C, E)
        # pos_embed.weight (H, C*E) viewed as (H, E, C), then (H, C, E)
        kernel = self.pos_embed.weight.view(H, E, C).transpose(1, 2)
        weight = torch.einsum('blce,hce->blhc', windows, kernel)
        out = torch.einsum('blhc,blce->blhe', weight, windows)
        out = out.sum(dim=2) / (H * C)
        return self.activation(self.norm(self.ffn(out)))


class ConvPredictor(_HistoryPredictor):
    """A depthwise conv over the last history_size + 1 embeddings."""

    def __init__(self, voca_size: int, embed_size: int, output_size: int,
                 embed_dropout: float, history_size: int = 2,
                 activation: str = 'relu', bias: bool = False,
                 layer_norm_epsilon: float = 1e-5):
        super().__init__()
        if output_size != embed_size:
            raise ValueError('ConvPredictor needs output_size == '
                             'embed_size')
        self.embed_size = embed_size
        self.context_size = history_size + 1
        self.embed = nn.Embedding(voca_size, embed_size)
        self.embed_dropout = nn.Dropout(embed_dropout)
        self.conv = nn.Conv1d(embed_size, embed_size, self.context_size,
                              groups=embed_size, bias=bias)
        self.norm = nn.LayerNorm(embed_size, eps=layer_norm_epsilon)
        self.activation = get_activation(activation)

    def _output(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(x.transpose(1, 2)).transpose(1, 2)
        return self.activation(self.norm(out))


PREDICTOR_CLASSES = {
    'rnn': RNNPredictor,
    'embedding': EmbeddingPredictor,
    'conv': ConvPredictor,
}

