"""The decode slice end to end: the tiny U2++ conformer through both
packages' `AsrRunner.decode`, and the port's independence from jax.

Same weights (converted with `state_dict_from_jax`), same numpy features.
CTC log-probs agree within 2e-4, and the hypotheses of CTC greedy, CTC
prefix beam (both through the shared C++ searcher) and attention
rescoring are identical."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import torch

from torch_port_utils import feats, jax_model, tiny_config, torch_model

MODES = ['ctc_greedy_search', 'ctc_prefix_beam_search',
         'attention_rescoring']
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_decode_matches_jax():
    import jax.numpy as jnp
    from wenet_tpu.models.runner import AsrRunner as JaxRunner
    from wenet_tpu_torch.models.runner import AsrRunner
    cfg = tiny_config()
    model, variables = jax_model(cfg, seed=11)
    tmodel = torch_model(cfg, variables)
    x, lens = feats(seed=12, B=4, T=91)
    kw = dict(beam_size=6, ctc_weight=0.3, reverse_weight=0.3)
    want = JaxRunner(model, variables).decode(MODES, x, lens, **kw)
    got = AsrRunner(tmodel, 'cpu').decode(MODES, x, lens, **kw)

    eo, _ = model.apply(variables, jnp.asarray(x), jnp.asarray(lens),
                        method=model.forward_encoder)
    jlogp = model.apply(variables, eo, method=model.ctc_logprobs)
    with torch.no_grad():
        teo, _ = tmodel.forward_encoder(torch.from_numpy(x),
                                        torch.from_numpy(lens))
        tlogp = tmodel.ctc_logprobs(teo)
    np.testing.assert_allclose(tlogp.numpy(), np.asarray(jlogp), atol=2e-4)

    for mode in MODES:
        assert [r.tokens for r in got[mode]] == \
            [r.tokens for r in want[mode]], mode
    for g, w in zip(got['ctc_prefix_beam_search'],
                    want['ctc_prefix_beam_search']):
        assert g.nbest == w.nbest
        np.testing.assert_allclose(g.nbest_scores, w.nbest_scores,
                                   atol=2e-4)
    for g, w in zip(got['attention_rescoring'], want['attention_rescoring']):
        np.testing.assert_allclose(g.score, w.score, atol=2e-3, rtol=1e-5)
        np.testing.assert_allclose(g.tokens_confidence, w.tokens_confidence,
                                   atol=2e-4)
    assert any(r.tokens for r in got['attention_rescoring'])


def test_attention_mode_matches_jax():
    """The flagship's `attention` beam search (the left decoder's
    incremental step over a sos prompt) gives the JAX package's
    hypotheses and scores."""
    from wenet_tpu.models.runner import AsrRunner as JaxRunner
    from wenet_tpu_torch.models.runner import AsrRunner
    cfg = tiny_config()
    model, variables = jax_model(cfg, seed=13)
    tmodel = torch_model(cfg, variables)
    x, lens = feats(seed=14, B=3, T=91)
    kw = dict(beam_size=4, length_penalty=0.3)
    want = JaxRunner(model, variables).decode(['attention'], x, lens,
                                              **kw)['attention']
    got = AsrRunner(tmodel, 'cpu').decode(['attention'], x, lens,
                                          **kw)['attention']
    assert [r.tokens for r in got] == [r.tokens for r in want]
    np.testing.assert_allclose([r.score for r in got],
                               [r.score for r in want], atol=1e-4, rtol=1e-5)


def test_port_runs_without_jax():
    """A fresh interpreter that imports the port and decodes the tiny
    slice on the CPU never imports jax."""
    code = textwrap.dedent('''
        import sys
        import numpy as np
        import torch
        from torch_port_utils import TINY_CONFIG, feats
        from wenet_tpu_torch.models.runner import AsrRunner
        from wenet_tpu_torch.utils.init_model import init_model
        model = init_model(TINY_CONFIG, torch.Generator().manual_seed(0),
                           device='cpu')
        x, lens = feats()
        out = AsrRunner(model, 'cpu').decode(
            ['ctc_greedy_search', 'ctc_prefix_beam_search',
             'attention_rescoring'], x, lens, beam_size=4,
            ctc_weight=0.3, reverse_weight=0.3)
        assert all(len(v) == len(lens) for v in out.values())
        assert 'jax' not in sys.modules, 'the port imported jax'
        print('ok')
    ''')
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [REPO, os.path.join(REPO, 'tests'), env.get('PYTHONPATH', '')])
    res = subprocess.run([sys.executable, '-c', code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith('ok')
