"""The registry sweep on the PyTorch port: every shipped recipe config
builds with `init_model(..., device='meta')` (shapes only, no weights
drawn); a model family the port did not have would raise
NotImplementedError naming its ROADMAP.md queue 1 item (none is left).
For the encoder zoo's, the transducers', the paraformer's and BEST-RQ's
yamls, shrunk as tests/test_example_configs.py shrinks them, the port's
state dict has the keys and shapes of the JAX package's variables
carried across by `state_dict_from_jax` (BEST-RQ's `bestrq` collection
too)."""

import copy
import glob
import os

import numpy as np
import pytest

from wenet_tpu_torch.utils.config import load_config
from wenet_tpu_torch.utils.init_model import init_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in glob.glob(
    os.path.join(REPO, 'examples/**/conf/*.yaml'), recursive=True))
UNPORTED = {}  # yaml -> its ROADMAP.md queue 1 item
ZOO = ['examples/aishell/s0/conf/train_transformer.yaml',
       'examples/timit/s0/conf/train_transformer.yaml',
       'examples/openasr2021/s0/conf/train_conformer_large_10h.yaml',
       'examples/aishell/s0/conf/train_ebranchformer.yaml',
       'examples/aishell/s0/conf/train_squeezeformer.yaml',
       'examples/aishell/s0/conf/train_u2pp_efficonformer.yaml']
TRANSDUCERS = ['examples/aishell/rnnt/conf/train_u2pp_transducer.yaml',
               'examples/librispeech/rnnt/conf/conformer_rnnt.yaml']
PARAFORMER = ['examples/aishell/paraformer/conf/train_paraformer.yaml']
SSL = ['examples/librispeech/ssl/conf/train_bestrq.yaml']
_SHRINK = {'num_blocks': 2, 'r_num_blocks': 1, 'linear_units': 64,
           'cgmlp_linear_units': 64, 'reduce_idx': 0, 'recover_idx': 1,
           'att_layer_num': 2}


def _configs(path, shrink=False):
    configs = load_config(os.path.join(REPO, path))
    if shrink:
        for conf in (configs['encoder_conf'],
                     configs.get('decoder_conf', {})):
            conf.update({k: v for k, v in _SHRINK.items() if k in conf})
    dataset_conf = configs.get('dataset_conf', {})
    configs['input_dim'] = dataset_conf.get('fbank_conf', dataset_conf.get(
        'log_mel_spectrogram_conf', {})).get('num_mel_bins', 80)
    if 'lfr_conf' in configs:  # the LFR features' width
        configs['input_dim'] *= configs['lfr_conf']['lfr_m']
    configs.setdefault('output_dim', 100)
    return configs


def test_sweep_counts():
    assert len(CONFIGS) == 23
    assert set(UNPORTED) | set(ZOO) | set(TRANSDUCERS) | set(
        PARAFORMER) | set(SSL) <= set(CONFIGS)
    assert not UNPORTED  # all 23 build


@pytest.mark.parametrize('path', CONFIGS)
def test_config_builds_or_names_its_item(path):
    configs = _configs(path)
    if path in UNPORTED:
        with pytest.raises(NotImplementedError,
                           match=f'queue 1 item {UNPORTED[path]}\\)'):
            init_model(configs, device='meta')
        return
    model = init_model(configs, device='meta')
    assert all(p.is_meta for p in model.parameters())
    assert model.encoder.output_size() == \
        configs['encoder_conf']['output_size']


@pytest.mark.parametrize('path', ZOO + TRANSDUCERS + PARAFORMER + SSL)
def test_zoo_state_dict_matches_jax(path):
    """Keys and shapes of the port's state dict == the JAX package's
    variables (abstract, `jax.eval_shape`) carried across (a transducer's
    predictor and joint too, a paraformer's CIF predictor and sampler
    embedding, fed features of the width before LFR; BEST-RQ's head and
    its quantizer's buffers)."""
    import jax
    import jax.numpy as jnp
    from wenet_tpu.utils.init_model import init_model as jax_init_model
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    configs = _configs(path, shrink=True)
    configs['cmvn'] = None
    jmodel, _ = jax_init_model(None, copy.deepcopy(configs))
    mel = configs['input_dim'] // configs.get('lfr_conf', {}).get('lfr_m', 1)
    shapes = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, mel)),
        jnp.asarray([32]), jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]))
    zeros = jax.tree_util.tree_map(
        lambda s: np.zeros(s.shape, np.float32), shapes)
    want = {k: tuple(v.shape) for k, v in state_dict_from_jax(zeros).items()}
    got = {k: tuple(v.shape) for k, v in
           init_model(configs, device='meta').state_dict().items()}
    assert got == want
