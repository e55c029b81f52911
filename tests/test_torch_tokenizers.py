"""The port's tokenizers (wenet_tpu_torch/text/, utils/init_tokenizer.py)
against the JAX package's, on the CPU, on files the tests write.

- Whisper: the port's plain-Python byte-level BPE against the JAX
  `WhisperTokenizer`, which runs `tiktoken`, on a rank file learned from
  seeded zh/en lines: ids identical on 2400 seeded strings (CJK, Latin
  with contractions, digits and other numerals, punctuation, whitespace
  runs with tabs, newlines, '\\x1c' and U+3000, '一二三', combining marks,
  emoji and special-token text), their decode the string itself; the
  pre-split equal to the `regex` module's findall of the pattern;
  `detokenize`, `vocab_size`, `special_tokens`, `symbol_table`, pickling
  and the rank-file search identical.
- BPE and sentencepiece over a stub `sentencepiece` module (greedy longest
  match over a piece list the test writes) put in `sys.modules` for both
  packages; huggingface on a `tokenizer.json` directory written with
  `tokenizers` and loaded by `transformers`.
- `init_tokenizer` for every tokenizer type.
- No module of the port imports tiktoken, regex, jax or wenet_tpu."""

import ast
import glob
import os
import pickle

import numpy as np
import pytest

from chip_smoke import EN_WORDS, ZH_CHARS, learn_byte_ranks, zh_en_lines
from torch_port_utils import stub_sentencepiece_module, write_ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PATTERN = (r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"""
           r"""| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""")
N_FUZZ = 2400
POOLS = [
    ZH_CHARS[:120] + list('一二三的了是'),
    list('abcdefghijklmnopqrstuvwxyzABCDEFXYZéüß'),
    ["'s", "'t", "'re", "'ve", "'m", "'ll", "'d", "'S", "'", "''", "'x"],
    list('0123456789²½Ⅻ٣'),
    list(',.!?;:"()[]-—…，。！？、'),
    [' ', '  ', '   ', '\t', '\n', '\r\n', '\xa0', '　', '\x1c', '\x0b',
     ' \t ', '\n\n'],
    ['一二三'],
    [chr(c) for c in range(0x300, 0x36f)],
    [chr(c) for c in range(0x1f600, 0x1f64f)],
    ['<|endoftext|>', '<|0.00|>', '<|zh|>', '<|notimestamps|>'],
    EN_WORDS,
]


def fuzz_strings(seed, n):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        parts = [POOLS[rng.randint(len(POOLS))] for _ in range(
            rng.randint(1, 14))]
        out.append(''.join(p[rng.randint(len(p))] for p in parts))
    return out


@pytest.fixture(scope='module')
def whisper_pair(tmp_path_factory):
    """(port tokenizer, JAX tokenizer, rank file) on 256 bytes + 300 merges
    learned from 150 seeded lines."""
    from wenet_tpu.text.whisper_tokenizer import WhisperTokenizer as Jax
    from wenet_tpu_torch.text.whisper_tokenizer import WhisperTokenizer
    d = tmp_path_factory.mktemp('whisper_tok')
    ranks = learn_byte_ranks(zh_en_lines(np.random.RandomState(0), 150), 300)
    path = write_ranks(d / 'multilingual.tiktoken', ranks)
    return WhisperTokenizer(vocab_path=path), Jax(vocab_path=path), path, \
        len(ranks)


@pytest.mark.parametrize('seed', [1, 2, 3])
def test_whisper_ids_match_tiktoken(whisper_pair, seed):
    port, jax_tok = whisper_pair[:2]
    for s in fuzz_strings(seed, N_FUZZ // 3):
        want = jax_tok.text2tokens(s)
        got = port.text2tokens(s)
        assert got == want, repr(s)
        assert port.tokens2text(got) == s == jax_tok.tokens2text(want)


def test_whisper_pre_split_is_the_pattern():
    regex = pytest.importorskip('regex')
    from wenet_tpu_torch.text.whisper_tokenizer import pre_split
    for s in fuzz_strings(4, 600) + ['', ' ', 'a  b', ' \t\na', "it's  "]:
        assert pre_split(s) == regex.findall(PATTERN, s), repr(s)


def test_whisper_surface_matches_jax(whisper_pair):
    """special_tokens, symbol_table, vocab_size, tokenize and detokenize
    (ids at and above the special tokens dropped), decoding a special
    token and a partial UTF-8 sequence, and pickling (the encoding is
    rebuilt after unpickling)."""
    port, jax_tok, _, n_ranks = whisper_pair
    assert port.special_tokens == jax_tok.special_tokens
    assert port.symbol_table == jax_tok.symbol_table
    assert port.vocab_size() == jax_tok.vocab_size() == n_ranks + 1609
    line = '你好 hello 世界, they\'ll go.'
    assert port.tokenize(line) == jax_tok.tokenize(line)
    ids = port.text2tokens(line)
    st = port.special_tokens
    mixed = [st['sot'], st['sot'] + 2, st['transcribe'], *ids,
             st['timestamp_begin'] + 7, st['eot']]
    assert port.detokenize(mixed) == jax_tok.detokenize(mixed)
    assert port.detokenize(mixed)[0] == line
    assert port.tokens2text([st['eot']]) == jax_tok.tokens2text([st['eot']])
    half = port.text2tokens('你')[:1]
    assert port.tokens2text(half) == jax_tok.tokens2text(half)
    clone = pickle.loads(pickle.dumps(port))
    assert clone.tokenizer is None
    assert clone.text2tokens(line) == ids


def test_whisper_rank_file_search(whisper_pair, tmp_path, monkeypatch):
    """vocab_path, else $WENET_WHISPER_ASSETS, else ~/.wenet/whisper_assets;
    without a file both raise the same FileNotFoundError at first use."""
    from wenet_tpu.text.whisper_tokenizer import WhisperTokenizer as Jax
    from wenet_tpu_torch.text.whisper_tokenizer import WhisperTokenizer
    port, _, path, _ = whisper_pair
    monkeypatch.setenv('HOME', str(tmp_path))
    monkeypatch.setenv('WENET_WHISPER_ASSETS', os.path.dirname(path))
    assert WhisperTokenizer().vocab_size() == port.vocab_size()
    assert Jax()._vocab_path == WhisperTokenizer()._vocab_path == path
    monkeypatch.delenv('WENET_WHISPER_ASSETS')
    home = tmp_path / '.wenet' / 'whisper_assets'
    home.mkdir(parents=True)
    (home / 'multilingual.tiktoken').write_bytes(open(path, 'rb').read())
    assert WhisperTokenizer()._vocab_path == str(home /
                                                 'multilingual.tiktoken')
    errors = []
    for cls in (WhisperTokenizer, Jax):
        with pytest.raises(FileNotFoundError) as e:
            cls(multilingual=False).vocab_size()
        errors.append(str(e.value))
    assert errors[0] == errors[1]


# --- bpe, sentencepiece, huggingface --------------------------------------
PIECES = ['<unk>', '▁', '▁HE', 'LLO', '▁WOR', 'LD', '▁THE', 'Y', "'LL",
          '▁GO', 'A', 'B', 'C', 'D', 'E', 'G', 'H', 'L', 'O', 'R', 'T', 'W']


@pytest.fixture
def spm_files(tmp_path, monkeypatch):
    """The stub in sys.modules, its piece list, a units file with the CJK
    chars, the pieces and <sos/eos>, and a non-linguistic symbol list."""
    monkeypatch.setitem(__import__('sys').modules, 'sentencepiece',
                        stub_sentencepiece_module())
    (tmp_path / 'bpe.model').write_text('\n'.join(PIECES) + '\n',
                                        encoding='utf-8')
    syms = ['<blank>', '<unk>'] + PIECES[1:] + ZH_CHARS[:10] + ['<sos/eos>']
    (tmp_path / 'units.txt').write_text(
        ''.join(f'{s} {i}\n' for i, s in enumerate(syms)), encoding='utf-8')
    (tmp_path / 'nls.txt').write_text('<NOISE>\n[LAUGH]\n')
    return tmp_path


LINES = ['hello world', "一丁 they'll go", '<noise> hello 七 [laugh] world',
         '  the  yellow ', 'xyz 丂']


@pytest.mark.parametrize('nls', [False, True])
def test_bpe_tokenizer_matches_jax(spm_files, nls):
    from wenet_tpu.text.bpe_tokenizer import BpeTokenizer as Jax
    from wenet_tpu_torch.text.bpe_tokenizer import BpeTokenizer
    d = spm_files
    args = (str(d / 'bpe.model'), str(d / 'units.txt'),
            str(d / 'nls.txt') if nls else None)
    port, jax_tok = BpeTokenizer(*args), Jax(*args)
    for line in LINES:
        assert port.tokenize(line) == jax_tok.tokenize(line)
        tokens, ids = port.tokenize(line)
        assert port.detokenize(ids) == jax_tok.detokenize(ids)
        assert port.tokens2text(tokens) == jax_tok.tokens2text(tokens)
    assert port.vocab_size() == jax_tok.vocab_size()
    clone = pickle.loads(pickle.dumps(port))
    assert clone.bpe_model is None and port.bpe_model is not None
    assert clone.tokenize(LINES[1]) == port.tokenize(LINES[1])


def test_sentencepiece_tokenizer_matches_jax(spm_files):
    from wenet_tpu.text.sentencepiece_tokenizer import (
        SentencepieceTokenizer as Jax)
    from wenet_tpu_torch.text.sentencepiece_tokenizer import (
        SentencepieceTokenizer)
    path = str(spm_files / 'bpe.model')
    port, jax_tok = SentencepieceTokenizer(path), Jax(path)
    for line in LINES:
        assert port.tokenize(line) == jax_tok.tokenize(line)
        ids = port.tokenize(line)[1]
        assert port.detokenize(ids) == jax_tok.detokenize(ids)
    assert port.vocab_size() == jax_tok.vocab_size() == len(PIECES)
    assert port.symbol_table == jax_tok.symbol_table
    assert pickle.loads(pickle.dumps(port)).model is None


def test_sentencepiece_absent_raises_as_jax(tmp_path, monkeypatch):
    """Without sentencepiece both raise the same ImportError at first use;
    tokens2text of the BPE tokenizer needs no model."""
    import sys
    from wenet_tpu.text.bpe_tokenizer import BpeTokenizer as JaxBpe
    from wenet_tpu.text.sentencepiece_tokenizer import (
        SentencepieceTokenizer as JaxSp)
    from wenet_tpu_torch.text.bpe_tokenizer import BpeTokenizer
    from wenet_tpu_torch.text.sentencepiece_tokenizer import (
        SentencepieceTokenizer)
    monkeypatch.setitem(sys.modules, 'sentencepiece', None)
    syms = {'<blank>': 0, '<unk>': 1, '▁HE': 2}
    for pair in ((BpeTokenizer('m', syms), JaxBpe('m', syms)),
                 (SentencepieceTokenizer('m'), JaxSp('m'))):
        msgs = []
        for tok in pair:
            with pytest.raises(ImportError) as e:
                tok.text2tokens('hello')
            msgs.append(str(e.value))
        assert msgs[0] == msgs[1]
    assert BpeTokenizer('m', syms).tokens2text(['▁HE', 'LLO']) == 'HELLO'


@pytest.fixture
def transformers_importable(monkeypatch):
    """Packages without a spec that other test files put in sys.modules
    as stand-ins (tests/refwenet.py: librosa, torchaudio, ...), with their
    submodules, are out of sys.modules while the test runs: `transformers`
    probes such packages with `importlib.util.find_spec`, which raises on
    a module without a spec."""
    import sys

    def stand_in(name):
        mod = sys.modules.get(name)
        return mod is not None and getattr(mod, '__spec__', False) is None

    for name in list(sys.modules):
        if name != '__main__' and stand_in(name.split('.')[0]):
            monkeypatch.delitem(sys.modules, name)


@pytest.fixture(scope='module')
def hf_dir(tmp_path_factory):
    """A WordLevel `tokenizer.json` with its config, written by
    `tokenizers`."""
    import json
    from tokenizers import Tokenizer, models, pre_tokenizers
    d = tmp_path_factory.mktemp('hf')
    vocab = {'[UNK]': 0, 'hello': 1, 'world': 2, '你': 3, '好': 4, '!': 5,
             'speech': 6}
    tok = Tokenizer(models.WordLevel(vocab, unk_token='[UNK]'))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(d / 'tokenizer.json'))
    (d / 'tokenizer_config.json').write_text(json.dumps(
        {'tokenizer_class': 'PreTrainedTokenizerFast', 'unk_token': '[UNK]'}))
    return str(d)


def test_huggingface_tokenizer_matches_jax(hf_dir, transformers_importable):
    from wenet_tpu.text.hugging_face_tokenizer import (
        HuggingFaceTokenizer as Jax)
    from wenet_tpu_torch.text.hugging_face_tokenizer import (
        HuggingFaceTokenizer)
    port, jax_tok = HuggingFaceTokenizer(hf_dir), Jax(hf_dir)
    for line in ('hello world', '你 好 ! speech', 'unknown words'):
        assert port.tokenize(line) == jax_tok.tokenize(line)
        ids = port.tokenize(line)[1]
        assert port.detokenize(ids) == jax_tok.detokenize(ids)
    assert port.vocab_size() == jax_tok.vocab_size() == 7
    assert port.symbol_table == jax_tok.symbol_table
    assert pickle.loads(pickle.dumps(port)).tokenizer is None


def test_tokenize_by_seg_dict_matches_jax():
    from wenet_tpu.text import tokenize_utils as jax_utils
    from wenet_tpu_torch.text import tokenize_utils
    seg = {'hello': 'he llo', 'world': 'wor ld'}
    for line in ('hello 你好 world', 'Hello  world一丁', 'xyz'):
        assert tokenize_utils.tokenize_by_seg_dict(seg, line) == \
            jax_utils.tokenize_by_seg_dict(seg, line)


# --- the factory ---------------------------------------------------------
def _configs(kind, d, hf, rank_file):
    conf = {
        'whisper': {'is_multilingual': True, 'num_languages': 100,
                    'vocab_path': rank_file},
        'char': {'symbol_table_path': str(d / 'units.txt'),
                 'non_lang_syms_path': str(d / 'nls.txt'),
                 'split_with_space': False, 'connect_symbol': ''},
        'bpe': {'bpe_path': str(d / 'bpe.model'),
                'symbol_table_path': str(d / 'units.txt'),
                'non_lang_syms_path': str(d / 'nls.txt')},
        'sentencepiece': {'model_path': str(d / 'bpe.model')},
        'huggingface': {'model': hf},
    }[kind]
    return {'tokenizer': kind, 'tokenizer_conf': conf}


@pytest.mark.parametrize('kind', ['whisper', 'char', 'bpe', 'sentencepiece',
                                  'huggingface'])
def test_init_tokenizer_matches_jax(kind, spm_files, hf_dir, whisper_pair,
                                    request):
    from wenet_tpu.utils.init_tokenizer import init_tokenizer as jax_init
    from wenet_tpu_torch.utils.init_tokenizer import init_tokenizer
    if kind == 'huggingface':
        request.getfixturevalue('transformers_importable')
    cfg = _configs(kind, spm_files, hf_dir, whisper_pair[2])
    port, jax_tok = init_tokenizer(cfg), jax_init(cfg)
    assert type(port).__name__ == type(jax_tok).__name__
    assert type(port).__module__.startswith('wenet_tpu_torch.text.')
    for line in ('hello world', '一丁 hello'):
        assert port.tokenize(line) == jax_tok.tokenize(line)
    assert port.vocab_size() == jax_tok.vocab_size()


def test_init_tokenizer_raises_for_paraformer(tmp_path):
    """The paraformer tokenizer is ported (tests/test_torch_paraformer.py
    holds it to the JAX package's): it raises only for files it cannot
    read, as the JAX package's does; an unknown kind raises
    NotImplementedError."""
    from wenet_tpu_torch.utils.init_tokenizer import init_tokenizer
    conf = {'symbol_table_path': str(tmp_path / 'units.txt'),
            'seg_dict_path': str(tmp_path / 'seg')}
    with pytest.raises(FileNotFoundError):
        init_tokenizer({'tokenizer': 'paraformer', 'tokenizer_conf': conf})
    (tmp_path / 'units.txt').write_text('<blank> 0\n<unk> 1\n你 2\n')
    (tmp_path / 'seg').write_text('hello\the llo\n')
    tok = init_tokenizer({'tokenizer': 'paraformer', 'tokenizer_conf': conf})
    assert tok.tokenize('你 hello')[0] == ['你', 'he', 'llo']
    with pytest.raises(NotImplementedError):
        init_tokenizer({'tokenizer': 'nope'})


def test_port_imports_no_tiktoken_regex_or_jax():
    """Every module of the port, by its import statements."""
    banned = ('tiktoken', 'regex', 'jax', 'wenet_tpu')
    bad = []
    for path in glob.glob(os.path.join(REPO, 'wenet_tpu_torch', '**',
                                       '*.py'), recursive=True):
        tree = ast.parse(open(path, encoding='utf-8').read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or '']
            else:
                continue
            bad += [(path, n) for n in names if n.split('.')[0] in banned]
    assert not bad
