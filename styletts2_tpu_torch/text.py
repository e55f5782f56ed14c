"""Text frontend (`styletts2_tpu/text.py`): the 178-symbol phoneme table,
`TextCleaner`, `encode_text`, the word tokenizer, the optional phonemizer
and `pad_token_batch`.

Index 0 is the pad symbol '$', then punctuation, Latin letters and IPA
symbols; unknown characters are dropped. Token ids feed both the
TextEncoder embedding and PL-BERT.

Phonemization (espeak-ng through the `phonemizer` package) is an optional
step, as in the reference, whose training lists are pre-phonemized:
`phonemize` raises ImportError without the package. `word_tokenize` uses
nltk where it is installed, else a regex split.
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

_PAD = "$"
_PUNCTUATION = ';:,.!?¡¿—…"«»“” '
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_LETTERS_IPA = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)

SYMBOLS: List[str] = [_PAD] + list(_PUNCTUATION) + list(_LETTERS) + list(_LETTERS_IPA)
SYMBOL_TO_ID: Dict[str, int] = {s: i for i, s in enumerate(SYMBOLS)}
N_SYMBOLS = len(SYMBOLS)  # 178, the config's n_token
PAD_ID = 0
# the regex tokenizer's split: runs of non-space, non-punctuation characters,
# and each punctuation mark on its own
_WORDS = re.compile(r"[^\s;:,.!?¡¿—…\"«»“”]+|[;:,.!?¡¿—…\"«»“”]")


class TextCleaner:
    """Characters -> token ids over the 178-symbol table; unknown
    characters are skipped (the reference prints and drops them)."""

    def __init__(self, dummy=None):
        self.word_index_dictionary = SYMBOL_TO_ID

    def __call__(self, text: str) -> List[int]:
        return [self.word_index_dictionary[c] for c in text if c in self.word_index_dictionary]


def encode_text(text: str, pad_start: bool = True, pad_end: bool = False) -> np.ndarray:
    """Phonemized text -> int32 token ids, with the pad id 0 prepended (the
    reference inference path) and, with `pad_end`, appended (its dataset)."""
    ids = TextCleaner()(text)
    if pad_start:
        ids = [PAD_ID] + ids
    if pad_end:
        ids = ids + [PAD_ID]
    return np.asarray(ids, dtype=np.int32)


def word_tokenize(text: str) -> List[str]:
    """nltk's `word_tokenize`, as the reference inference cells use it; its
    `TreebankWordTokenizer` where the punkt model is not installed (the
    same tokens for one sentence); without nltk, a regex split with each
    punctuation mark a token of its own."""
    try:
        from nltk.tokenize import word_tokenize as _wt

        try:
            return _wt(text)
        except LookupError:
            pass
    except Exception:  # a broken nltk install: the next tokenizer
        pass
    try:
        from nltk.tokenize import TreebankWordTokenizer

        return TreebankWordTokenizer().tokenize(text)
    except Exception:  # no nltk
        return _WORDS.findall(text)


def phonemize(text: str, language: str = "en-us") -> str:
    """Raw text -> IPA, as the reference inference preprocessing: strip,
    drop double quotes, espeak-ng over the whole text, `word_tokenize`,
    join with spaces. ImportError without the `phonemizer` package."""
    try:
        from phonemizer.backend import EspeakBackend
    except Exception as e:  # a missing or broken optional package
        raise ImportError(
            "phonemizer/espeak-ng not installed; pass pre-phonemized IPA text instead") from e
    backend = EspeakBackend(language=language, preserve_punctuation=True, with_stress=True)
    text = text.strip().replace('"', "")
    return " ".join(word_tokenize(backend.phonemize([text])[0]))


def pad_token_batch(token_lists: Sequence[np.ndarray],
                    max_len: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
    """Zero-pad token id arrays to (B, max_len or the longest); returns
    (tokens int32, their lengths int32). An array longer than `max_len` is
    cut; its length stays the uncut one, as the JAX function's."""
    lengths = np.asarray([len(t) for t in token_lists], dtype=np.int32)
    T = int(max_len if max_len is not None else lengths.max())
    out = np.zeros((len(token_lists), T), dtype=np.int32)
    for i, t in enumerate(token_lists):
        out[i, : len(t)] = t[:T]
    return out, lengths
