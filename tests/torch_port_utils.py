"""Shared set-up for the tests of the PyTorch port (tests/test_torch_*.py):
one tiny U2++ conformer config built in both packages on the same
weights, and numpy inputs made from a seed."""

import copy

import numpy as np

IDIM = 40
VOCAB = 30

TINY_CONFIG = {
    'input_dim': IDIM,
    'output_dim': VOCAB,
    'encoder': 'conformer',
    'encoder_conf': {
        'output_size': 64, 'attention_heads': 2, 'linear_units': 128,
        'num_blocks': 2, 'dropout_rate': 0.1,
        'positional_dropout_rate': 0.1, 'attention_dropout_rate': 0.1,
        'input_layer': 'conv2d', 'normalize_before': True,
        'cnn_module_kernel': 8, 'use_cnn_module': True,
        'activation_type': 'swish', 'pos_enc_layer_type': 'rel_pos',
        'selfattention_layer_type': 'rel_selfattn', 'causal': True,
        'use_dynamic_chunk': True, 'cnn_module_norm': 'layer_norm',
        'use_dynamic_left_chunk': False,
    },
    'decoder': 'bitransformer',
    'decoder_conf': {
        'attention_heads': 2, 'linear_units': 128, 'num_blocks': 2,
        'r_num_blocks': 2, 'dropout_rate': 0.1,
        'positional_dropout_rate': 0.1,
        'self_attention_dropout_rate': 0.1,
        'src_attention_dropout_rate': 0.1,
    },
    'tokenizer_conf': {'special_tokens': {'<blank>': 0, '<unk>': 1,
                                          '<sos>': 2, '<eos>': 2}},
    'ctc_conf': {'ctc_blank_id': 0},
    'cmvn': 'global_cmvn',
    'model': 'asr_model',
    'model_conf': {'ctc_weight': 0.3, 'lsm_weight': 0.1,
                   'length_normalized_loss': False, 'reverse_weight': 0.3},
}


def tiny_config(**encoder_overrides):
    cfg = copy.deepcopy(TINY_CONFIG)
    cfg['encoder_conf'].update(encoder_overrides)
    return cfg


def jax_model(cfg, seed=0):
    """JAX model + variables with random cmvn and perturbed norms, so a
    layout or transpose slip cannot hide behind zeros and ones."""
    import jax
    from wenet_tpu.utils.init_model import init_model, init_variables
    model, configs = init_model(None, copy.deepcopy(cfg))
    variables, _ = init_variables(model, configs,
                                  rng=jax.random.PRNGKey(seed))
    rng = np.random.RandomState(seed)

    def perturb(path, leaf):
        leaf = np.asarray(leaf)
        name = path[-1].key
        if name in ('scale', 'var', 'istd'):
            return (1.0 + 0.2 * rng.rand(*leaf.shape)).astype(leaf.dtype)
        if name == 'bias' or name == 'mean':
            return (leaf + 0.1 * rng.randn(*leaf.shape)).astype(leaf.dtype)
        return leaf

    variables = jax.tree_util.tree_map_with_path(perturb, variables)
    return model, variables


def torch_model(cfg, variables):
    """The port's model carrying the JAX variables (strict load)."""
    from wenet_tpu_torch.utils.checkpoint import state_dict_from_jax
    from wenet_tpu_torch.utils.init_model import init_model
    model = init_model(copy.deepcopy(cfg), device='cpu')
    model.load_state_dict(state_dict_from_jax(variables), strict=True)
    return model.eval()


def feats(seed=0, B=3, T=67):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, IDIM).astype(np.float32)
    lens = np.asarray([T] + list(rng.randint(T // 2, T, size=B - 1)),
                      np.int32)
    return x, lens


# --- tiny whisper: the dims of tests/test_whisper.py, a text context long
# enough for every beam-search position (n_text_ctx >= T' + 2) ---
WHISPER_DIMS = {'n_mels': 40, 'n_vocab': 120, 'n_audio_state': 32,
                'n_audio_head': 2, 'n_audio_layer': 2, 'n_text_state': 32,
                'n_text_head': 2, 'n_text_layer': 2, 'n_audio_ctx': 64,
                'n_text_ctx': 48}
WHISPER_TOKENS = {'sot': 110, 'eot': 109, 'sot_prev': 111, 'transcribe': 112,
                  'translate': 113, 'no_timestamps': 114, 'no_speech': 115,
                  'timestamp_begin': 116}


def whisper_config():
    from wenet_tpu_torch.models.whisper.convert import build_config
    return build_config(WHISPER_DIMS, WHISPER_TOKENS)


def whisper_models(seed=0, eot_bias=0.0):
    """(JAX model, its variables, the port's model) on one set of weights;
    `eot_bias` is added to the output bias of eot, so that random weights
    end their beams."""
    cfg = whisper_config()
    model, variables = jax_model(cfg, seed)
    bias = np.array(variables['params']['decoder']['output_layer']['bias'])
    bias[WHISPER_TOKENS['eot']] += eot_bias
    variables['params']['decoder']['output_layer']['bias'] = bias
    return model, variables, torch_model(cfg, variables)


def whisper_feats(seed=0, B=3, T=63):
    """(B, T, n_mels) features; the first row full, the others shorter."""
    rng = np.random.RandomState(seed)
    x = rng.randn(B, T, WHISPER_DIMS['n_mels']).astype(np.float32)
    lens = np.asarray([T] + list(rng.randint(T // 2, T, size=B - 1)),
                      np.int32)
    return x, lens


def fill_allocator_with_nan():
    """Leave the CUDA caching allocator's free blocks, small and large,
    full of NaN (allocate, fill, free), so that an output a kernel does
    not write reads NaN."""
    import torch
    blocks = [torch.full((1 << 18,), float('nan'), device='cuda')
              for _ in range(32)]  # 1 MiB each: the small pool
    blocks.append(torch.full((1 << 26,), float('nan'), device='cuda'))
    torch.cuda.synchronize()
    del blocks
