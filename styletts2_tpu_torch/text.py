"""The 178-symbol phoneme table and `encode_text`.

Index 0 is the pad symbol '$', then punctuation, Latin letters and IPA
symbols; unknown characters are dropped. Same table as
`styletts2_tpu/text.py`.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

_PAD = "$"
_PUNCTUATION = ';:,.!?¡¿—…"«»“” '
_LETTERS = "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz"
_LETTERS_IPA = (
    "ɑɐɒæɓʙβɔɕçɗɖðʤəɘɚɛɜɝɞɟʄɡɠɢʛɦɧħɥʜɨɪʝɭɬɫɮʟɱɯɰŋɳɲɴøɵɸθœɶʘɹɺɾɻʀʁɽʂʃʈʧʉʊʋⱱʌɣɤʍχʎʏʑʐʒʔʡʕʢǀǁǂǃˈˌːˑʼʴʰʱʲʷˠˤ˞↓↑→↗↘'̩'ᵻ"
)

SYMBOLS: List[str] = [_PAD] + list(_PUNCTUATION) + list(_LETTERS) + list(_LETTERS_IPA)
SYMBOL_TO_ID: Dict[str, int] = {s: i for i, s in enumerate(SYMBOLS)}
PAD_ID = 0


def encode_text(text: str) -> np.ndarray:
    """Phonemized text -> int32 token ids, with a leading pad id 0 as in the
    reference inference path."""
    return np.asarray([PAD_ID] + [SYMBOL_TO_ID[c] for c in text if c in SYMBOL_TO_ID],
                      dtype=np.int32)
