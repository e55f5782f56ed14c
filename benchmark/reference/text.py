"""The StyleTTS 2 phoneme table (178 symbols, index 0 the pad '$') and the
inference path's token encoding: the pad id prepended, unknown characters
dropped (yl4579/StyleTTS2 `text_utils.py`)."""

from __future__ import annotations

import numpy as np

_PAD = "$"
_PUNCTUATION = ';:,.!?¡¿—…"«»“” '
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_LETTERS_IPA = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)
SYMBOLS = [_PAD] + list(_PUNCTUATION) + list(_LETTERS) + list(_LETTERS_IPA)
SYMBOL_TO_ID = {s: i for i, s in enumerate(SYMBOLS)}


def encode(text: str) -> np.ndarray:
    """Phonemized text -> int64 token ids with the pad id 0 in front."""
    return np.asarray([0] + [SYMBOL_TO_ID[c] for c in text if c in SYMBOL_TO_ID], np.int64)
