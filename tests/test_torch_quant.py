"""int8 weight-only quantization of the port (ops/quant.py and
`AsrRunner(quantize=True)`) against the JAX package's (wenet_tpu/ops/
quant.py, its runner), at the tiny width of tests/torch_port_utils.py on
the JAX package's weights.

The same tensors are quantized, their int8 values and scales are equal
bit for bit, `quantized_bytes` agrees, the dequantized bf16 weights are
equal bit for bit; with float32 as the compute dtype the two quantized
runners agree within the per-layer bar (2e-4) and decode the same
hypotheses; in bf16 the quantized runner's greedy tokens agree with the
float runner's on at least 90% of the frames (tests/test_smoke_core.py's
bar)."""

import numpy as np
import pytest
import torch

from torch_port_utils import feats, jax_model, tiny_config, torch_model

MODES = ['ctc_greedy_search', 'ctc_prefix_beam_search',
         'attention_rescoring', 'attention']


@pytest.fixture(scope='module')
def pair():
    cfg = tiny_config()
    model, variables = jax_model(cfg, seed=41)
    return cfg, model, variables


def _jax_quantized(variables):
    """{torch key: (int8, scale)} of the JAX `quantize_int8`, in the port's
    layout."""
    import jax
    from wenet_tpu.ops.quant import quantize_int8
    from wenet_tpu_torch.utils.checkpoint import torch_key
    qvars, scales = quantize_int8(variables)
    flat_q = jax.tree_util.tree_flatten_with_path(qvars)[0]
    flat_s = jax.tree_util.tree_leaves(scales)
    out = {}
    for (path, q), s in zip(flat_q, flat_s):
        q = np.asarray(q)
        if q.dtype != np.int8:
            continue
        key = torch_key(tuple(str(getattr(k, 'key', k)) for k in path))
        s = np.asarray(s)
        if path[-1].key == 'kernel':  # (in, out) -> (out, in[, 1])
            q, s = q.T, s.T
            if 'pointwise_conv' in key:
                q, s = q[:, :, None], s[:, :, None]
        out[key] = (q, s)
    return out


def _port_quantized(cfg, variables):
    from wenet_tpu_torch.ops.quant import quantizable, quantize_int8
    model = torch_model(cfg, variables)
    return {k: tuple(t.numpy() for t in quantize_int8(m.weight, dims))
            for k, (m, dims) in quantizable(model).items()}


def test_same_tensors_are_quantized(pair):
    cfg, _, variables = pair
    got, want = _port_quantized(cfg, variables), _jax_quantized(variables)
    assert set(got) == set(want)
    # linear maps and the pointwise convs; the decoder embeddings
    # (30 x 64) are below the size the rule quantizes
    assert any('pointwise_conv1' in k for k in got)
    assert not any('embed.0' in k for k in got)


def test_int8_tensors_and_scales_equal_jax_bit_for_bit(pair):
    cfg, _, variables = pair
    got, want = _port_quantized(cfg, variables), _jax_quantized(variables)
    for k, (q, s) in want.items():
        assert got[k][0].dtype == np.int8, k
        np.testing.assert_array_equal(got[k][0], q, err_msg=k)
        np.testing.assert_array_equal(got[k][1], s, err_msg=k)


def test_dequantized_bf16_weights_equal_jax(pair):
    import jax.numpy as jnp
    from wenet_tpu.ops.quant import dequantize as jax_dequantize
    from wenet_tpu_torch.ops.quant import dequantize
    cfg, _, variables = pair
    want = _jax_quantized(variables)
    for k, (q, s) in list(want.items())[:6]:
        j = np.asarray(jax_dequantize({'w': jnp.asarray(q)},
                                      {'w': jnp.asarray(s)})['w'],
                       np.float32)
        t = dequantize(torch.from_numpy(np.array(q)),
                       torch.from_numpy(np.array(s)),
                       torch.bfloat16).float().numpy()
        np.testing.assert_array_equal(t, j, err_msg=k)


def test_quantized_bytes_equal_jax(pair):
    from wenet_tpu.ops.quant import quantized_bytes as jax_bytes
    from wenet_tpu_torch.ops.quant import quantized_bytes
    cfg, _, variables = pair
    got = quantized_bytes(torch_model(cfg, variables))
    assert got == jax_bytes(variables)
    assert got[1] < got[0]


def test_quantized_model_keeps_int8_weights(pair):
    from torch.nn.utils import parametrize
    from wenet_tpu_torch.models.runner import AsrRunner
    from wenet_tpu_torch.ops.quant import quantizable
    cfg, _, variables = pair
    model = torch_model(cfg, variables)
    picked = quantizable(model)
    runner = AsrRunner(model, 'cpu', quantize=True)
    assert runner.dtype == torch.bfloat16
    mods = dict(runner.model.named_modules())
    for k in picked:
        m = mods[k.rsplit('.', 1)[0]]
        assert parametrize.is_parametrized(m, 'weight'), k
        assert m.parametrizations.weight.original.dtype == torch.int8, k
        assert m.parametrizations.weight[0].scale.dtype == torch.float32, k
        assert m.weight.dtype == torch.bfloat16, k
    floats = [p for n, p in runner.model.named_parameters()
              if p.is_floating_point()]
    assert floats and all(p.dtype == torch.bfloat16 for p in floats)


def test_fp32_quantized_runner_matches_jax(pair):
    """Both quantized runners computing in float32 on the dequantized
    weights: encoder outputs and CTC log-probs within 2e-4, the same
    hypotheses in every mode."""
    import jax.numpy as jnp
    from wenet_tpu.models.runner import AsrRunner as JaxRunner
    from wenet_tpu_torch.models.runner import AsrRunner
    cfg, model, variables = pair
    x, lens = feats(seed=42, B=3, T=96)
    jr = JaxRunner(model, variables, dtype=jnp.float32, quantize=True)
    tr = AsrRunner(torch_model(cfg, variables), 'cpu', dtype=torch.float32,
                   quantize=True)
    eo, em = jr.forward_encoder(jnp.asarray(x), jnp.asarray(lens))
    with torch.inference_mode():
        teo, tem = tr.model.forward_encoder(torch.from_numpy(x),
                                            torch.from_numpy(lens))
        tlp = tr.model.ctc_logprobs(teo)
    np.testing.assert_allclose(teo.numpy(), np.asarray(eo), atol=2e-4)
    np.testing.assert_allclose(tlp.numpy(),
                               np.asarray(jr.ctc_logprobs(eo)), atol=2e-4)
    want = jr.decode(MODES, jnp.asarray(x), jnp.asarray(lens), beam_size=3)
    got = tr.decode(MODES, x, lens, beam_size=3)
    for m in MODES:
        assert [list(r.tokens) for r in got[m]] == \
            [list(r.tokens) for r in want[m]], m


def test_bf16_quantized_greedy_agrees_with_float(pair):
    """The quantized runner (bf16) against the float one, and against the
    JAX package's quantized runner: greedy tokens agree on >= 90% of the
    frames of every utterance."""
    import jax.numpy as jnp
    from wenet_tpu.models.runner import AsrRunner as JaxRunner
    from wenet_tpu_torch.models.runner import AsrRunner
    cfg, model, variables = pair
    x, lens = feats(seed=43, B=2, T=120)
    fp = AsrRunner(torch_model(cfg, variables), 'cpu')
    q = AsrRunner(torch_model(cfg, variables), 'cpu', quantize=True)
    jq = JaxRunner(model, variables, quantize=True)
    with torch.inference_mode():
        got = []
        for r in (fp, q):
            eo, em = r.model.forward_encoder(
                torch.from_numpy(x).to(r.dtype or torch.float32),
                torch.from_numpy(lens))
            got.append(r.model.ctc_logprobs(eo).float().argmax(-1).numpy())
    jeo, _ = jq.forward_encoder(jnp.asarray(x), jnp.asarray(lens))
    jax_ids = np.asarray(jq.ctc_logprobs(jeo)).argmax(-1)
    T = (lens - 1) // 2 // 2 - 1
    for b, t in enumerate(T):
        assert np.mean(got[0][b, :t] == got[1][b, :t]) >= 0.9
        assert np.mean(jax_ids[b, :t] == got[1][b, :t]) >= 0.9
    res = q.decode(MODES, x, lens, beam_size=3)
    assert all(len(res[m]) == 2 for m in MODES)
