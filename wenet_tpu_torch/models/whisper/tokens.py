"""Whisper's language list, special-token layout, decode prompt and
timestamp segments.  The port's own copy of
wenet_tpu/models/whisper/tokens.py (`WHISPER_LANGS`,
`build_whisper_prefix`, `whisper_tokens_to_segments`) and of
`_special_tokens` in wenet_tpu/text/whisper_tokenizer.py."""

from typing import Dict, List, Optional

# language order must match whisper.tokenizer.LANGUAGES key order
WHISPER_LANGS = (
    "en", "zh", "de", "es", "ru", "ko", "fr", "ja", "pt", "tr", "pl",
    "ca", "nl", "ar", "sv", "it", "id", "hi", "fi", "vi", "he", "uk",
    "el", "ms", "cs", "ro", "da", "hu", "ta", "no", "th", "ur", "hr",
    "bg", "lt", "la", "mi", "ml", "cy", "sk", "te", "fa", "lv", "bn",
    "sr", "az", "sl", "kn", "et", "mk", "br", "eu", "is", "hy", "ne",
    "mn", "bs", "kk", "sq", "sw", "gl", "mr", "pa", "si", "km", "sn",
    "yo", "so", "af", "oc", "ka", "be", "tg", "sd", "gu", "am", "yi",
    "lo", "uz", "fo", "ht", "ps", "tk", "nn", "mt", "sa", "lb", "my",
    "bo", "tl", "mg", "as", "tt", "haw", "ln", "ha", "ba", "jw", "su",
    "yue",
)


def special_token_ids(n_vocab_base: int,
                      num_languages: int) -> Dict[str, int]:
    """The special tokens' ids, in whisper's order after the
    `n_vocab_base` text tokens."""
    specials = [
        '<|endoftext|>',
        '<|startoftranscript|>',
        *[f'<|{lang}|>' for lang in WHISPER_LANGS[:num_languages]],
        '<|translate|>', '<|transcribe|>', '<|startoflm|>',
        '<|startofprev|>', '<|nospeech|>', '<|notimestamps|>',
        *[f'<|{i * 0.02:.2f}|>' for i in range(1501)],
    ]
    return {tok: n_vocab_base + i for i, tok in enumerate(specials)}


def build_whisper_prefix(special_tokens: Dict[str, int], task: str,
                         lang: str, no_timestamp: bool = True) -> List[int]:
    """[sot, lang, task, no_timestamps | <|0.00|>] decode prompt.

    With `no_timestamp=False` the prompt ends with the timestamp_begin
    anchor (<|0.00|>) and the beam search applies the timestamp grammar
    to every generated step (search.py `_apply_timestamp_rules`)."""
    if task == 'transcribe':
        task_id = special_tokens['transcribe']
    elif task == 'translate':
        task_id = special_tokens['translate']
    elif task == 'vad':
        task_id = special_tokens['no_speech']
    else:
        raise NotImplementedError(f'unsupported task {task}')
    language_id = special_tokens['sot'] + 1 + WHISPER_LANGS.index(lang)
    prefix = [special_tokens['sot'], language_id, task_id]
    if task in ('transcribe', 'translate'):
        if no_timestamp:
            prefix.append(special_tokens['no_timestamps'])
        else:
            prefix.append(special_tokens['timestamp_begin'])
    else:
        prefix.append(special_tokens['no_speech'])
    return prefix


def whisper_tokens_to_segments(tokens: List[int], timestamp_begin: int,
                               precision: float = 0.02):
    """Split a timestamp decode's hypothesis (the prompt, which ends with
    <|0.00|> and so opens the first segment, stripped) into timed segments.

    The grammar makes the stream `text+ t_close (t_open text+ t_close)*`,
    each `t` a token >= timestamp_begin meaning (t - timestamp_begin) *
    precision seconds.  -> (the text tokens, [(start_sec, end_sec, [token
    ids])]); end_sec is None for a segment the decode ended inside."""
    segments = []
    text: List[int] = []
    cur: List[int] = []
    cur_start: Optional[float] = 0.0  # the prompt's <|0.00|>
    for t in tokens:
        t = int(t)
        if t >= timestamp_begin:
            sec = round((t - timestamp_begin) * precision, 4)
            if cur_start is None:  # an opening timestamp
                cur_start = sec
            else:  # a closing one
                segments.append((cur_start, sec, cur))
                cur, cur_start = [], None
        else:
            cur.append(t)
            text.append(t)
    if cur and cur_start is not None:
        segments.append((cur_start, None, cur))
    return text, segments
