"""The whisper decode slice: the port's tiny whisper against the JAX
package on the same weights, module by module and end to end, plus the
build checks at large-v3's dims and the port's C++ prefix-beam searcher.

Tiny whisper has the dims of tests/test_whisper.py with a text context of
48 (>= T' + 2 for the beam search's positions).  Encoder output and step
log-probs agree within 2e-4; the timestamp filter is exact; the
`attention` beam search gives identical hypotheses (scores within 1e-4)
with and without timestamps, at beam 1 and 4, on a ragged batch whose
beams end at different steps (an eot bias) or run to the step cap."""

import copy
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from torch_port_utils import (WHISPER_DIMS, WHISPER_TOKENS, whisper_config,
                              whisper_feats, whisper_models)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D = WHISPER_DIMS['n_audio_state']
EOT_BIAS = 0.8  # ends some beams early and lets others hit the cap


@pytest.fixture(scope='module')
def models():
    return whisper_models(seed=5, eot_bias=EOT_BIAS)


@pytest.mark.parametrize('T', [63, 64])
def test_conv1d_subsampling(models, T):
    """conv k3 + conv k3 stride 2 + GELU, and the mask slice
    x_mask[:, :, (T + 1) % 2::2], for odd and even T."""
    import jax.numpy as jnp
    model, variables, tmodel = models
    x, lens = whisper_feats(seed=1, B=2, T=T)
    mask = np.arange(T)[None, None, :] < lens[:, None, None]
    want, _, want_mask = model.apply(
        variables, jnp.asarray(x), jnp.asarray(mask),
        method=lambda m, x, mk: m.encoder.embed(x, mk))
    with torch.no_grad():
        got, _, got_mask = tmodel.encoder.embed(torch.from_numpy(x),
                                                torch.from_numpy(mask))
    assert got.shape == (2, (T + 1) // 2, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


def test_whisper_position_encoding():
    from wenet_tpu.models.transformer.embedding import (
        whisper_position_encoding as jax_pe)
    from wenet_tpu_torch.models.transformer.embedding import (
        whisper_position_encoding)
    # fp32 angles up to 1500 rad: one ulp of the inverse frequency moves
    # sin and cos by ~1e-4 at the last positions (the 2e-4 forward bar)
    got = whisper_position_encoding(1500, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_pe(0, 1500, 64)),
                               atol=2e-4)
    np.testing.assert_allclose(got[:, :100].numpy(),
                               np.asarray(jax_pe(0, 100, 64)), atol=1e-5)


@pytest.mark.parametrize('offset,T', [(0, 7), (5, 1), (45, 5)])
def test_learnable_position_encoding(offset, T):
    """The learned table at positions [offset, offset + T); past max_len
    (45 + 5 > 48) both read NaN."""
    import jax.numpy as jnp
    from wenet_tpu.models.transformer.embedding import (
        LearnablePositionalEncoding as JaxPE)
    from wenet_tpu_torch.models.transformer.embedding import (
        LearnablePositionalEncoding)
    rng = np.random.RandomState(offset)
    pe = rng.randn(1, 48, 16).astype(np.float32)
    x = rng.randn(2, T, 16).astype(np.float32)
    want, _ = JaxPE(16, max_len=48).apply(
        {'params': {'pe': jnp.asarray(pe)}}, jnp.asarray(x),
        offset if offset == 0 else jnp.asarray(offset))
    mod = LearnablePositionalEncoding(16, 0.0, 48)
    with torch.no_grad():
        mod.pe.copy_(torch.from_numpy(pe))
        got, _ = mod(torch.from_numpy(x), offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    assert np.isnan(got.numpy()).any() == (offset + T > 48)


@pytest.mark.parametrize('T', [63, 48])
def test_encoder_matches_jax(models, T):
    import jax.numpy as jnp
    model, variables, tmodel = models
    x, lens = whisper_feats(seed=2, B=3, T=T)
    want, want_mask = model.apply(variables, jnp.asarray(x),
                                  jnp.asarray(lens),
                                  method=model.forward_encoder)
    with torch.no_grad():
        got, got_mask = tmodel.forward_encoder(torch.from_numpy(x),
                                               torch.from_numpy(lens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))


@pytest.mark.parametrize('beam', [1, 3])
def test_decoder_forward_step_matches_jax(models, beam):
    """Step log-probs over a prompt plus text tokens.  The JAX state is
    built on the beam-repeated encoder output; the port's projects the
    encoder keys once per utterance and expands the queries."""
    import jax.numpy as jnp
    model, variables, tmodel = models
    x, lens = whisper_feats(seed=3, B=2, T=40)
    eo, em = model.apply(variables, jnp.asarray(x), jnp.asarray(lens),
                         method=model.forward_encoder)
    rng = np.random.RandomState(4)
    tokens = np.concatenate(
        [np.tile([[110, 111, 112, 114]], (2 * beam, 1)),
         rng.randint(0, 100, size=(2 * beam, 6))], axis=1)
    enc_r, mask_r = jnp.repeat(eo, beam, 0), jnp.repeat(em, beam, 0)
    state = model.apply(variables, enc_r, 12,
                        method=model.decoder_init_state)
    with torch.no_grad():
        teo, tem = (torch.from_numpy(np.asarray(a)) for a in (eo, em))
        tstate = tmodel.decoder_init_state(teo, 12, beam)
        for i in range(tokens.shape[1]):
            want, state = model.apply(
                variables, jnp.asarray(tokens[:, i:i + 1]), jnp.asarray(i),
                state, mask_r, method=model.decoder_forward_step)
            got, tstate = tmodel.decoder_forward_step(
                torch.from_numpy(tokens[:, i:i + 1]), i, tstate, tem)
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=2e-4, err_msg=f'step {i}')


@pytest.mark.parametrize('seed,pen_exists', [(0, True), (1, True),
                                             (2, False), (3, True)])
def test_timestamp_rules_exact(seed, pen_exists):
    import jax.numpy as jnp
    from wenet_tpu.models.transformer.search import (
        _apply_timestamp_rules as jax_rules)
    from wenet_tpu_torch.models.transformer.search import (
        _apply_timestamp_rules)
    rng = np.random.RandomState(seed)
    R, V, ts_begin, eot = 16, 120, 100, 90
    logp = (rng.randn(R, V) * 3).astype(np.float32)
    logp[:, ts_begin:] += rng.randn(R, 1).astype(np.float32) * 4
    last = rng.choice([5, 90, 95, 100, 104, 110], size=R)
    pen = rng.choice([5, 101, 103, 110], size=R)
    ts_max = rng.randint(ts_begin, V, size=R)
    want = jax_rules(jnp.asarray(logp), jnp.asarray(last), jnp.asarray(pen),
                     jnp.asarray(pen_exists), jnp.asarray(ts_max), ts_begin,
                     eot)
    got = _apply_timestamp_rules(torch.from_numpy(logp),
                                 torch.from_numpy(last), torch.from_numpy(pen),
                                 pen_exists, torch.from_numpy(ts_max),
                                 ts_begin, eot)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize('timestamps', [False, True])
@pytest.mark.parametrize('beam', [1, 4])
def test_attention_beam_search_matches_jax(models, beam, timestamps):
    from wenet_tpu.models.runner import AsrRunner as JaxRunner
    from wenet_tpu_torch.models.runner import AsrRunner
    model, variables, tmodel = models
    x, lens = whisper_feats(seed=6, B=3, T=63)
    infos = {'tasks': ['transcribe', 'translate', 'transcribe'],
             'langs': ['en', 'zh', 'de'], 'no_timestamp': not timestamps}
    kw = dict(beam_size=beam, length_penalty=0.5, infos=infos)
    want = JaxRunner(model, variables).decode(['attention'], x, lens,
                                              **kw)['attention']
    got = AsrRunner(tmodel, 'cpu').decode(['attention'], x, lens,
                                          **kw)['attention']
    assert [r.tokens for r in got] == [r.tokens for r in want]
    np.testing.assert_allclose([r.score for r in got],
                               [r.score for r in want], atol=1e-4, rtol=1e-5)
    if beam > 1:  # utterances end at different steps (greedy runs on)
        assert len({len(r.tokens) for r in got}) > 1


def test_beam_stops_when_all_beams_end(models, monkeypatch):
    """Checking the end flags every step or every 8 steps gives the same
    result (steps after every beam ended change nothing)."""
    from wenet_tpu_torch.models.transformer import search
    _, _, tmodel = models
    x, lens = whisper_feats(seed=7, B=2, T=63)
    tm = copy.deepcopy(tmodel)
    with torch.no_grad():
        tm.decoder.output_layer.bias[WHISPER_TOKENS['eot']] += 0.1
        eo, em = tm.forward_encoder(torch.from_numpy(x),
                                    torch.from_numpy(lens))
        monkeypatch.setattr(search, 'CHECK_EVERY', 1)
        a = search.attention_beam_search(tm, eo, em, 4)
        monkeypatch.setattr(search, 'CHECK_EVERY', 8)
        b = search.attention_beam_search(tm, eo, em, 4)
    assert [r.tokens for r in a] == [r.tokens for r in b]
    assert [r.score for r in a] == [r.score for r in b]
    assert max(len(r.tokens) for r in a) < 29


def test_build_config_matches_jax():
    from wenet_tpu.models.whisper.convert import (
        build_config as jax_build_config,
        default_special_tokens as jax_tokens)
    from wenet_tpu_torch.models.whisper.convert import (
        build_config, default_special_tokens)
    for n_vocab in (51864, 51865, 51866):
        assert default_special_tokens(n_vocab) == jax_tokens(n_vocab)
    assert whisper_config() == jax_build_config(WHISPER_DIMS, WHISPER_TOKENS)


LARGE_V3 = {'n_mels': 128, 'n_vocab': 51866, 'n_audio_state': 1280,
            'n_audio_head': 20, 'n_audio_layer': 32, 'n_text_state': 1280,
            'n_text_head': 20, 'n_text_layer': 32, 'n_audio_ctx': 1500,
            'n_text_ctx': 448}


def _large_v3_keys(lora_conf=None):
    """large-v3 on the meta device in the port, and abstractly in the JAX
    package (`jax.eval_shape`): (the port's model, its key -> shape, the
    JAX key -> shape through `state_dict_from_jax`'s mapping)."""
    import jax
    import jax.numpy as jnp
    from wenet_tpu.utils.init_model import init_model as jax_init_model
    from wenet_tpu_torch.models.whisper.convert import (
        build_config, default_special_tokens)
    from wenet_tpu_torch.utils.checkpoint import _flatten, torch_key
    from wenet_tpu_torch.utils.init_model import init_model
    cfg = build_config(LARGE_V3, default_special_tokens(51866))
    if lora_conf is not None:
        cfg['lora_conf'] = lora_conf
    model = init_model(copy.deepcopy(cfg), device='meta')
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    jmodel, _ = jax_init_model(None, copy.deepcopy(cfg))
    abstract = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0), jnp.zeros((1, 16, 128)),
        jnp.asarray([16]), jnp.zeros((1, 4), jnp.int32), jnp.asarray([4]))
    jax_keys = {torch_key(path): leaf.shape
                for path, leaf in _flatten(abstract)}
    return model, shapes, jax_keys


def _n_params(shapes):
    return sum(int(np.prod(s)) for s in shapes.values())


def test_large_v3_builds_with_jax_keys():
    """large-v3 on the meta device: the JAX package's key set (through
    `state_dict_from_jax`'s mapping) and parameter count, abstractly."""
    model, shapes, jax_keys = _large_v3_keys()
    assert set(shapes) == set(jax_keys)
    n = _n_params(shapes)
    assert n == _n_params(jax_keys)
    assert 1.55e9 < n < 1.65e9  # 1.54B + the CTC head
    assert model.sos == 50258 and model.eos == 50257
    assert 'encoder.encoders.0.self_attn.linear_k.bias' not in shapes
    assert shapes['decoder.embed.1.pe'] == (1, 448, 1280)


# the finetune yaml's lora_conf (examples/aishell/whisper/conf/
# finetune_whisper_largev3.yaml)
YAML_LORA = {'use_lora': True, 'lora_rank': 8, 'lora_alpha': 8,
             'lora_dropout': 0.0, 'lora_list': ['o', 'q', 'k', 'v']}


@pytest.mark.parametrize('lora_decoder', [False, True])
def test_large_v3_lora_builds_with_jax_keys(lora_decoder):
    """large-v3 with the finetune yaml's lora_conf on the meta device:
    the JAX model's key set, shapes and parameter count; lora_A (8, 1280)
    and lora_B (1280, 8) on every encoder projection, and on the
    decoder's only with `lora_decoder`."""
    model, shapes, jax_keys = _large_v3_keys(
        dict(YAML_LORA, lora_decoder=lora_decoder))
    assert set(shapes) == set(jax_keys)
    assert all(np.prod(shapes[k]) == np.prod(jax_keys[k]) for k in shapes)
    lora = [k for k in shapes if k.endswith(('lora_A', 'lora_B'))]
    # lora_A / lora_B are in torch layout in both packages
    assert all(shapes[k] == tuple(jax_keys[k]) for k in lora)
    enc = 32 * 4 * 2
    assert len(lora) == enc + (32 * 8 * 2 if lora_decoder else 0)
    assert shapes['encoder.encoders.7.self_attn.linear_k.lora_A'] == (8,
                                                                      1280)
    assert shapes['encoder.encoders.7.self_attn.linear_out.lora_B'] == (
        1280, 8)
    assert (('decoder.decoders.0.src_attn.linear_v.lora_A' in shapes)
            == lora_decoder)
    from wenet_tpu_torch.models.whisper.convert import (
        build_config, default_special_tokens)
    from wenet_tpu_torch.utils.init_model import init_model
    plain = init_model(build_config(LARGE_V3, default_special_tokens(51866)),
                       device='meta').state_dict()
    assert {k: tuple(v.shape) for k, v in plain.items()} == {
        k: v for k, v in shapes.items() if k not in lora}
    assert _n_params(shapes) == _n_params(jax_keys) == (
        sum(t.numel() for t in plain.values()) + len(lora) * 8 * 1280)


def test_bf16_runner_decodes(models):
    """AsrRunner(dtype=bfloat16) casts the weights and features."""
    from wenet_tpu_torch.models.runner import AsrRunner
    _, _, tmodel = models
    x, lens = whisper_feats(seed=8, B=2, T=40)
    runner = AsrRunner(copy.deepcopy(tmodel), 'cpu', dtype=torch.bfloat16)
    assert next(runner.model.parameters()).dtype == torch.bfloat16
    out = runner.decode(['attention'], x, lens, beam_size=2)['attention']
    assert len(out) == 2 and all(np.isfinite(r.score) for r in out)


def test_native_beam_matches_jax_package():
    """The port's C++ searcher (its own copy, built with g++) and the JAX
    package's give the same hyps, times and scores on one top-k."""
    from wenet_tpu.runtime import native_beam as jax_beam
    from wenet_tpu_torch.runtime import native_beam
    if not jax_beam.available():
        pytest.skip('the JAX package\'s native searcher did not build')
    rng = np.random.RandomState(9)
    B, T, V, K = 3, 50, 12, 4
    logits = rng.randn(B, T, V).astype(np.float32) * 2
    logp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    ids = np.argsort(-logp, axis=-1)[..., :K].astype(np.int32)
    vals = np.take_along_axis(logp, ids, -1)
    lens = np.asarray([50, 37, 12])
    got = native_beam.batch_search_topk(vals, ids, lens, K)
    want = jax_beam.batch_search_topk(vals, ids, lens, K)
    for (gh, gt, gs), (wh, wt, ws) in zip(got, want):
        assert gh == wh and gt == wt
        np.testing.assert_array_equal(gs, ws)


def test_whisper_decode_runs_without_jax():
    """A fresh interpreter that builds tiny whisper and decodes in the
    attention mode imports neither jax nor any wenet_tpu module."""
    code = textwrap.dedent('''
        import sys
        import torch
        from torch_port_utils import whisper_config, whisper_feats
        from wenet_tpu_torch.models.runner import AsrRunner
        from wenet_tpu_torch.utils.init_model import init_model
        model = init_model(whisper_config(),
                           torch.Generator().manual_seed(0), device='cpu')
        x, lens = whisper_feats()
        out = AsrRunner(model, 'cpu').decode(
            ['attention', 'ctc_prefix_beam_search'], x, lens, beam_size=2,
            infos={'no_timestamp': False})
        assert all(len(v) == len(lens) for v in out.values())
        bad = [m for m in sys.modules
               if m == 'jax' or m.split('.')[0] == 'wenet_tpu']
        assert not bad, bad
        print('ok')
    ''')
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [REPO, os.path.join(REPO, 'tests'), env.get('PYTHONPATH', '')])
    out = subprocess.run([sys.executable, '-c', code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().endswith('ok')


@pytest.mark.parametrize('mask_rows', [1, 5])
def test_cross_attention_folds_beams(mask_rows):
    """Beam-expanded queries against one utterance's keys give what the
    keys repeated per beam give, with a (B, 1, T) or (B, T1, T) mask."""
    from wenet_tpu_torch.models.transformer.attention import (
        MultiHeadedCrossAttention)
    torch.manual_seed(0)
    attn = MultiHeadedCrossAttention(4, 32).eval()
    B, N, T1, T = 2, 3, 5, 9
    q = torch.randn(B * N, T1, 32)
    mem = torch.randn(B, T, 32)
    mask = torch.rand(B, mask_rows, T) > 0.3
    mask[:, :, 0] = True
    with torch.no_grad():
        got = attn(q, mem, mem, mask)
        want = attn(q, mem.repeat_interleave(N, 0),
                    mem.repeat_interleave(N, 0),
                    mask.repeat_interleave(N, 0))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
