"""The decode and streaming holds of tests/test_torch_refused_options.py
(its families, models and bars), in a file of their own so that the
tier-1 command's workers run the parts side by side: every decode
mode's hypotheses identical to the JAX package's, the `no_pos` decoder's
steps, streaming equal to the full forward under the chunk mask within
1e-4 (or to the JAX chunk loop within 2e-4).  The export and checkpoint
holds are in tests/test_torch_refused_options_export.py."""

import copy

import numpy as np
import pytest
import torch

from test_torch_refused_options import (FAMILIES, FULL_ATOL, _close, batch,
                                        models)
from torch_port_utils import IDIM, TINY_CONFIG, VOCAB, jax_model


MODES = ['ctc_greedy_search', 'ctc_prefix_beam_search',
         'attention_rescoring', 'attention']


@pytest.mark.parametrize('name', sorted(FAMILIES))
def test_decode_matches_jax(name):
    """Every decode mode (for the decoder families: attention rescoring
    and the attention beam search, the incremental step, with the
    beam-folded cross attention where there is one) gives the JAX
    package's hypotheses.  Without an output layer the decoder's log-probs
    are over its D = 64 hidden units, not the 30 tokens, so the beam
    search picks ids past the vocabulary, which the JAX package's
    embedding clamps and the port's refuses (IndexError): there the
    attention beam search is not held."""
    from wenet_tpu.models.runner import AsrRunner as JaxRunner
    from wenet_tpu_torch.models.runner import AsrRunner
    cfg, model, variables, tmodel = models(name)
    x, lens, _, _ = batch(3, B=4, T=91)
    modes = [m for m in MODES
             if not (name == 'decoder_no_output_layer' and m == 'attention')]
    kw = dict(beam_size=3, ctc_weight=0.3,
              reverse_weight=cfg['model_conf']['reverse_weight'])
    want = JaxRunner(model, variables).decode(modes, x, lens, **kw)
    got = AsrRunner(tmodel, 'cpu').decode(modes, x, lens, **kw)
    for mode in modes:
        assert [r.tokens for r in got[mode]] == \
            [r.tokens for r in want[mode]], mode


def test_no_pos_decoder_matches_jax():
    """The `no_pos` decoder takes (B, L, D) embeddings, as the JAX one
    does: its forward and two incremental steps on the same float inputs
    within 2e-4; token ids raise, as they fail in the JAX package's
    model."""
    import jax
    import jax.numpy as jnp
    from wenet_tpu.models.transformer.decoder import (
        TransformerDecoder as JaxDecoder)
    from wenet_tpu_torch.models.transformer.decoder import TransformerDecoder
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    from wenet_tpu_torch.utils.init_model import init_model
    conf = dict(attention_heads=2, linear_units=128, num_blocks=2,
                dropout_rate=0.0, positional_dropout_rate=0.0,
                input_layer='no_pos')
    rng = np.random.RandomState(6)
    mem = rng.randn(2, 9, 64).astype(np.float32)
    mem_mask = np.arange(9)[None, None, :] < np.asarray([9, 6])[:, None,
                                                                None]
    tgt = rng.randn(2, 5, 64).astype(np.float32)
    lens = np.asarray([5, 3])
    jd = JaxDecoder(vocab_size=VOCAB, encoder_output_size=64, **conf)
    variables = jd.init(jax.random.PRNGKey(3), jnp.asarray(mem),
                        jnp.asarray(mem_mask), jnp.asarray(tgt),
                        jnp.asarray(lens))
    td = TransformerDecoder(VOCAB, 64, **conf).eval()
    td.load_state_dict(state_dict_from_jax(variables), strict=True)
    want = jd.apply(variables, jnp.asarray(mem), jnp.asarray(mem_mask),
                    jnp.asarray(tgt), jnp.asarray(lens))[0]
    with torch.no_grad():
        got, _ = td(torch.from_numpy(mem), torch.from_numpy(mem_mask),
                    torch.from_numpy(tgt), torch.from_numpy(lens))
    _close(got, want)
    jstate = jd.apply(variables, jnp.asarray(mem), 4,
                      method=jd.init_state)
    with torch.no_grad():
        tstate = td.init_state(torch.from_numpy(mem), 4)
        for step in range(2):
            tok = tgt[:, step:step + 1]
            jlogp, jstate = jd.apply(variables, jnp.asarray(tok), step,
                                     jstate, jnp.asarray(mem_mask),
                                     method=jd.forward_step)
            tlogp, tstate = td.forward_step(torch.from_numpy(tok), step,
                                            tstate,
                                            torch.from_numpy(mem_mask))
            _close(tlogp, jlogp)
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg['decoder_conf']['input_layer'] = 'no_pos'
    with pytest.raises(ValueError, match='decoder.py:129'):
        tmodel = init_model(cfg, device='cpu')
        x, xl, t, tl = batch(4)
        tmodel(*(torch.from_numpy(np.asarray(a)) for a in (x, xl, t, tl)))
    with pytest.raises(ValueError):  # the JAX model fails on the ids too
        jax_model(cfg)


@pytest.mark.parametrize('name', sorted(n for n, f in FAMILIES.items()
                                         if f[3] is not None))
def test_streaming(name):
    """Chunk 4 over a padded tail: the chunk loop equals the full forward
    under the chunk mask (1e-4), or where the encoder does not stream so
    (Squeezeformer's time reduction, the efficient conformer's strides)
    the JAX package's chunk loop (2e-4)."""
    import jax.numpy as jnp
    from wenet_tpu.models.transformer.streaming import (
        StreamingConfig as JaxConfig, forward_chunk_by_chunk as jax_fcc)
    from wenet_tpu_torch.models.transformer.streaming import (
        StreamingConfig, forward_chunk_by_chunk)
    _, model, variables, tmodel = models(name)
    how = FAMILIES[name][3]
    frames = 143
    x = np.random.RandomState(5).randn(1, frames, IDIM).astype(np.float32)
    with torch.inference_mode():
        ty, _ = forward_chunk_by_chunk(tmodel, torch.from_numpy(x),
                                       StreamingConfig(4, -1))
        if how == 'full':
            want, _ = tmodel.forward_encoder(torch.from_numpy(x),
                                             torch.tensor([frames]), 4, -1)
            assert ty.shape == want.shape
            _close(ty, want.numpy(), FULL_ATOL)
            return
    jy, _ = jax_fcc(model, variables, jnp.asarray(x), JaxConfig(4, -1))
    assert tuple(ty.shape) == jy.shape
    _close(ty, jy)
