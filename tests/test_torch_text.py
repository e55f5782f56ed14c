"""The port's text helpers (`styletts2_tpu_torch/text.py`) against the JAX
package's (`styletts2_tpu/text.py`) on a seeded set of strings: the
symbol table, `TextCleaner`, `encode_text` with every pad choice,
`word_tokenize` on this machine's tokenizer and on the regex path (nltk
blocked on both sides), `phonemize` without `phonemizer`, and
`pad_token_batch`; then `demo --seed`, which must draw the weights from
the seed it is given. Everything is compared exactly.
"""

import dataclasses
import json
import sys

import numpy as np
import pytest
import torch

import styletts2_tpu.text as jt
import styletts2_tpu_torch.text as pt

# table symbols, characters outside it, and the regex split's whitespace
ALPHABET = pt.SYMBOLS[1:] + list("0123456789#@&*_\t\n") + ["  "]


def seeded_strings(n: int = 40, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = ["", " ", "ðɪs ɪz ɐ tˈɛst, wɪð kˈɑːməz; ænd «kwˈoʊts»!",
           "Hello, world... it's 3 o'clock?", "mˈɪstɚ smˈɪθ wˈɛnt hˈoʊm."]
    for _ in range(n):
        out.append("".join(rng.choice(ALPHABET, int(rng.integers(1, 60)))))
    return out


def test_table_and_cleaner_match_jax():
    assert pt.SYMBOLS == jt.SYMBOLS and pt.SYMBOL_TO_ID == jt.SYMBOL_TO_ID
    assert pt.N_SYMBOLS == jt.N_SYMBOLS == 178 and pt.PAD_ID == jt.PAD_ID == 0
    for s in seeded_strings():
        assert pt.TextCleaner()(s) == jt.TextCleaner()(s)


@pytest.mark.parametrize("pad_start,pad_end", [(True, False), (False, False), (True, True),
                                               (False, True)])
def test_encode_text_matches_jax(pad_start, pad_end):
    for s in seeded_strings(seed=1):
        got = pt.encode_text(s, pad_start=pad_start, pad_end=pad_end)
        want = jt.encode_text(s, pad_start=pad_start, pad_end=pad_end)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_encode_text_default_is_unchanged():
    """The default call gives the ids the port's `encode_text(text)` gave
    before its pad arguments: a leading pad, then the known characters."""
    for s in seeded_strings(seed=2):
        want = [0] + [pt.SYMBOL_TO_ID[c] for c in s if c in pt.SYMBOL_TO_ID]
        np.testing.assert_array_equal(pt.encode_text(s), np.asarray(want, np.int32))


def test_word_tokenize_matches_jax():
    """This machine's tokenizer (nltk's, where installed) on both sides."""
    for s in seeded_strings(seed=3):
        assert pt.word_tokenize(s) == jt.word_tokenize(s)


def test_word_tokenize_regex_path_matches_jax(monkeypatch):
    """nltk unimportable on both sides: the regex split, each punctuation
    mark a token."""
    for name in ("nltk", "nltk.tokenize"):
        monkeypatch.setitem(sys.modules, name, None)
    assert pt.word_tokenize("hˈɛloʊ, wˈɜːld!  ɪts «mˈiː»…") == [
        "hˈɛloʊ", ",", "wˈɜːld", "!", "ɪts", "«", "mˈiː", "»", "…"]
    for s in seeded_strings(seed=4):
        assert pt.word_tokenize(s) == jt.word_tokenize(s)


def test_phonemize_needs_phonemizer(monkeypatch):
    for name in ("phonemizer", "phonemizer.backend"):
        monkeypatch.setitem(sys.modules, name, None)
    for fn in (pt.phonemize, jt.phonemize):
        with pytest.raises(ImportError):
            fn("hello")


@pytest.mark.parametrize("max_len", [None, 7, 40])
def test_pad_token_batch_matches_jax(max_len):
    rng = np.random.default_rng(5)
    lists = [pt.encode_text(s) for s in seeded_strings(8, seed=6)]
    lists.append(rng.integers(1, 178, 0).astype(np.int32))
    got, got_len = pt.pad_token_batch(lists, max_len)
    want, want_len = jt.pad_token_batch(lists, max_len)
    assert got.dtype == want.dtype and got_len.dtype == want_len.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got_len, want_len)


def test_demo_seed_draws_the_weights(tmp_path, monkeypatch):
    """`demo --seed 3` synthesises with the weights of Synthesizer(seed=3)
    (the sampler's draws too), not with seed 0's."""
    from styletts2_tpu_torch import demo, inference
    from styletts2_tpu_torch.parallel.tiny import tiny_config

    cfg_path = tmp_path / "tiny.json"
    cfg_path.write_text(json.dumps(dataclasses.asdict(tiny_config())))
    used = {}

    def record(self, text, **kw):  # the weights and the draws' seed; no synthesis
        used.update(state=self.models.state_dict(), seed=kw.get("seed"))
        return np.zeros(2400, np.float32), None

    monkeypatch.setattr(inference.Synthesizer, "inference", record)
    demo.main(["--text", "ðɪs ɪz ɐ tˈɛst.", "--out", str(tmp_path / "out.wav"),
               "--config", str(cfg_path), "--seed", "3", "--device", "cpu"])
    want = inference.Synthesizer(tiny_config(), seed=3, device="cpu").models.state_dict()
    assert used["seed"] == 3 and used["state"].keys() == want.keys()
    assert all(torch.equal(used["state"][k], want[k]) for k in want)
