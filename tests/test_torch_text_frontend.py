"""Port parity for the text frontend: each expander, the cleaner, the
punctuation strip and restore, the rule G2Ps (en, es, fr), the CMUdict
loader, the espeak wrapper (on a fake binary) and `Tokenizer` must give
the JAX package's output, string for string and id for id, over a fixed
corpus of numbers, currency, years, times, abbreviations and punctuation
in en, es and fr, and over random strings (hypothesis). The frontend is
pure Python on both sides, so the tolerance is equality."""

import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from naturalspeech2_tpu.utils import cleaner as jcleaner
from naturalspeech2_tpu.utils import tokenizer as jtokenizer
from naturalspeech2_tpu.utils.expand import abbreviations as jabbr
from naturalspeech2_tpu.utils.expand import number_norm as jnum
from naturalspeech2_tpu.utils.expand import time_norm as jtime
from naturalspeech2_tpu.utils.phonemizers import espeak_wrapper as jew
from naturalspeech2_tpu.utils.phonemizers import fallback as jfallback
from naturalspeech2_tpu.utils.phonemizers import punctuation as jpunct
from naturalspeech2_tpu_torch.utils import cleaner, tokenizer
from naturalspeech2_tpu_torch.utils.expand import abbreviations, number_norm, time_norm
from naturalspeech2_tpu_torch.utils.phonemizers import espeak_wrapper as ew
from naturalspeech2_tpu_torch.utils.phonemizers import fallback, punctuation

# (language, text): numbers, currency, years, times, abbreviations and
# punctuation in each language the frontend expands
CORPUS = [
    ("en", "Hello, Mr. Smith! It is 9:30 am, and the bill is $5.20."),
    ("en", "Dr. Jones paid $1,000 for 3 books in 1999; that's 42 dollars each?"),
    ("en", "In 2005 (not 2000) we met at 12:05 pm on St. James Ave."),
    ("en", "Meet at 5:30 tomorrow -- bring 17 apples, 0 pears & $0.99."),
    ("en", "The years 1900, 2008 and 2024 were... odd; Prof. X said \"no\"."),
    ("en", "Call Intl. Corp. at 23:59 or 00:00; it costs $12.345.67 - weird."),
    ("en", "She said: 'checking things is nicely done', then walked away!"),
    ("en", "Minus -7 degrees vs. 101 dalmatians [sic] <3 etc."),
    ("en", "€5 and £300 and ¥7 and ₹12: the $ table only knows dollars."),
    ("en", "A 1,234,567 word novel, no. 9 of 1,000,000,000,001 copies."),
    ("es", "Hola, Sr. García: tengo 30 manzanas y 21 peras."),
    ("es", "La Dra. López llegó a las 9:15 pm; costó 1500 pesos."),
    ("es", "¿Cuántos años? ¡Tengo 100, no 101! Av. Central, no. 2024."),
    ("es", "El año 1999 fue largo... y el 2005 también, etc."),
    ("es", "Quinientos 500, setecientos 700, un millón 1000000."),
    ("fr", "Bonjour M. Dupont, il est 10:45 et j'ai 71 pommes."),
    ("fr", "Mme. Martin habite au 99 bd. Saint-Germain, etc."),
    ("fr", "Quatre-vingts: 80; quatre-vingt-dix-neuf: 99; mille cinq cents: 1500!"),
    ("fr", "Le Dr. Leroy a payé 200 euros en 2008 (cher ?)."),
    ("fr", "Ste. Anne, no. 21 -- « bien » dit-il... 1000000 fois."),
]
IDS = [f"{lang}{i}" for i, (lang, _) in enumerate(CORPUS)]
NUMBERS = [0, 1, 7, 13, 16, 20, 21, 29, 30, 31, 42, 69, 70, 71, 77, 80, 81, 90, 91, 99, 100,
           101, 120, 200, 201, 500, 999, 1000, 1001, 1500, 1999, 2000, 2005, 2024, 10000, 21000,
           100000, 999999, 1000000, 1000001, 2000000, 123456789, -5, -1200]
ESPEAK_LANG = {"en": "en-us", "es": "es", "fr": "fr-fr"}


def _pair(lang):
    """(port, JAX) tokenizers over the rule G2P of ``lang``."""
    g2p = fallback.RuleBasedG2P(ESPEAK_LANG[lang])
    jg2p = jfallback.RuleBasedG2P(ESPEAK_LANG[lang])
    return tokenizer.Tokenizer(phonemizer=g2p), jtokenizer.Tokenizer(phonemizer=jg2p)


@pytest.mark.parametrize("lang", ["en", "fr", "es"])
def test_number_to_words_matches_jax(lang):
    assert [number_norm.number_to_words(n, lang) for n in NUMBERS] == [
        jnum.number_to_words(n, lang) for n in NUMBERS]


@pytest.mark.parametrize("lang, text", CORPUS, ids=IDS)
def test_corpus_matches_jax(lang, text):
    """Every stage of the frontend on one sentence, port against JAX."""
    assert time_norm.TimeExpander().expand_time(text, language=lang) == \
        jtime.TimeExpander().expand_time(text, language=lang)

    norm, jnorm = number_norm.NumberNormalizer(), jnum.NumberNormalizer()
    for n in (norm, jnorm):
        n.add_currency("$", {0.01: "cent", 0.02: "cents", 1: "dollar", 2: "dollars"})
    assert norm.normalize_numbers(text, language=lang) == jnorm.normalize_numbers(
        text, language=lang)

    assert abbreviations.AbbreviationExpander().replace_text_abbreviations(text, lang) == \
        jabbr.AbbreviationExpander().replace_text_abbreviations(text, lang)

    cleaned = cleaner.TextProcessor().phoneme_cleaners(text, language=lang)
    assert cleaned == jcleaner.TextProcessor().phoneme_cleaners(text, language=lang)

    p, jp = punctuation.Punctuation(), jpunct.Punctuation()
    assert p.strip(cleaned) == jp.strip(cleaned)
    segments, marks = p.strip_to_restore(cleaned)
    jsegments, jmarks = jp.strip_to_restore(cleaned)
    assert segments == jsegments
    assert [(m.punc, m.position.name) for m in marks] == [
        (m.punc, m.position.name) for m in jmarks]
    assert "".join(punctuation.Punctuation.restore(segments, marks)) == "".join(
        jpunct.Punctuation.restore(jsegments, jmarks))

    for keep in (True, False):
        g2p = fallback.RuleBasedG2P(ESPEAK_LANG[lang], keep_puncs=keep)
        jg2p = jfallback.RuleBasedG2P(ESPEAK_LANG[lang], keep_puncs=keep)
        assert g2p.phonemize(cleaned, separator="") == jg2p.phonemize(cleaned, separator="")

    tok, jtok = _pair(lang)
    ids, got_cleaned, phonemes = tok.text_to_ids(text, language=lang)
    assert (ids, got_cleaned, phonemes) == jtok.text_to_ids(text, language=lang)
    assert tok.decode(ids) == jtok.decode(ids)


def test_default_tokenizer_batch_matches_jax():
    """`Tokenizer()` as `build_ns2` makes it: the padded [b, max_len] int32
    batch, pad id and vocabulary."""
    tok, jtok = tokenizer.Tokenizer(), jtokenizer.Tokenizer()
    texts = [text for lang, text in CORPUS if lang == "en"] + ["hi", ""]
    ids, jids = tok.texts_to_tensor_ids(texts), jtok.texts_to_tensor_ids(texts)
    assert ids.dtype == jids.dtype == np.int32 and ids.shape == jids.shape
    np.testing.assert_array_equal(ids, jids)
    assert (ids[-1] == tok.pad_id).all() and tok.pad_id == -1
    assert tok.vocab_size == jtok.vocab_size == 125
    assert tok.vocab == jtok.vocab and tok.char_to_id == jtok.char_to_id
    assert tokenizer.DEFAULT_PHONEMES == jtokenizer.DEFAULT_PHONEMES
    assert tok.espeak_language == jtok.espeak_language


@pytest.mark.parametrize("add_blank, use_eos_bos", [(True, False), (False, True), (True, True)])
def test_blank_and_bos_eos_match_jax(add_blank, use_eos_bos):
    kw = dict(add_blank=add_blank, use_eos_bos=use_eos_bos, pad_id=0)
    tok = tokenizer.Tokenizer(phonemizer=fallback.RuleBasedG2P(), **kw)
    jtok = jtokenizer.Tokenizer(phonemizer=jfallback.RuleBasedG2P(), **kw)
    texts = ["hello world", "hi", "Mr. Smith at 9:30 am"]
    np.testing.assert_array_equal(tok.texts_to_tensor_ids(texts), jtok.texts_to_tensor_ids(texts))
    ids, _, _ = tok.text_to_ids("hi")
    if use_eos_bos:
        assert ids[0] == tok.bos_id and ids[-1] == tok.eos_id
    if add_blank:
        assert tok.blank_id in ids
    assert tok.decode(ids) == jtok.decode(ids)


def test_unknown_characters_dropped_as_jax():
    tok, jtok = _pair("en")
    assert tok.encode("h💙iə!") == jtok.encode("h💙iə!")
    assert tok.not_found_characters == jtok.not_found_characters == ["💙", "!"]


_ALPHABET = st.sampled_from(
    list("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789")
    + list(" .,;:!?'\"()-$€£%&/<>[]") + ["Mr. ", "Dr. ", " am", " pm", ":", "  ", "é", "ñ"])


@settings(max_examples=150, derandomize=True, deadline=None, database=None)
@given(st.lists(_ALPHABET, min_size=0, max_size=40).map("".join),
       st.sampled_from(["en", "es", "fr"]))
def test_random_strings_give_jax_ids(text, lang):
    tok, jtok = _pair(lang)
    assert tok.text_to_ids(text, language=lang) == jtok.text_to_ids(text, language=lang)


def test_cmudict_lexicon_matches_jax(tmp_path, monkeypatch):
    """A CMUdict file (both formats: comments, alternates, latin-1) read by
    `load_cmudict_lexicon`, through ``lexicon_path=`` and ``NS2_CMUDICT``."""
    path = tmp_path / "cmudict-0.7b"
    path.write_bytes("\n".join([
        ";;; # CMUdict  --  Major Version: 0.07",
        "ZYGOTE  Z AY1 G OW0 T",
        "ZYGOTE(2)  Z IH1 G OW0 T",
        "QUORUM  K W AO1 R AH0 M",
        "HELLO  HH EH0 L OW1",
        "WE'RE  W IH1 R",
        "CAFÉ  K AE0 F EY1",
        "BROKEN  XX YY",
        "thistle  TH IH1 S AH0 L",
    ]).encode("latin-1"))
    lex = fallback.load_cmudict_lexicon(path)
    assert lex == jfallback.load_cmudict_lexicon(str(path))
    assert lex["zygote"] == jfallback.arpabet_to_ipa(["Z", "AY1", "G", "OW0", "T"])
    text = "the zygote quorum said hello, we're thistle"
    g2p, jg2p = (fallback.RuleBasedG2P(lexicon_path=str(path)),
                 jfallback.RuleBasedG2P(lexicon_path=str(path)))
    assert g2p.phonemize(text, separator="") == jg2p.phonemize(text, separator="")
    assert g2p.phonemize(text, separator="") != fallback.RuleBasedG2P().phonemize(text, separator="")
    monkeypatch.setenv("NS2_CMUDICT", str(path))
    assert fallback.RuleBasedG2P().phonemize(text, separator="") == jg2p.phonemize(
        text, separator="")


# ----------------------- espeak wrapper (fake binary) ------------------- #


def _fake_espeak(tmp_path, name, version_line, voices=None, phon_out="_h_ə_l_ˈoʊ"):
    """Install a fake espeak binary on PATH emitting canned output."""
    voices = voices or [
        "Pty Language Age/Gender VoiceName          File          Other Languages",
        " 5  en-us          M  english-us     en-us          (en 3)",
        " 5  fr             M  french         fr",
        " 7  cmn            M  chinese        zh",
    ]
    script = tmp_path / name
    lines = [
        "#!/bin/sh",
        'for a in "$@"; do',
        '  case "$a" in',
        f'    --version) echo "{version_line}"; exit 0;;',
        "    --voices) cat << 'VOICES'",
        *voices,
        "VOICES",
        "    exit 0;;",
        "  esac",
        "done",
        f'echo "{phon_out}"',
    ]
    script.write_text("\n".join(lines) + "\n")
    script.chmod(0o755)
    return script


@pytest.fixture()
def on_path(tmp_path, monkeypatch):
    def install(name, version_line, **kw):
        _fake_espeak(tmp_path, name, version_line, **kw)
        monkeypatch.setenv("PATH", f"{tmp_path}:/usr/bin:/bin")
        ew.ESpeak._LANG_CACHE.clear()
        jew.ESpeak._LANG_CACHE.clear()
    return install


def test_espeak_ng_version_parsing(on_path):
    on_path("espeak-ng", "eSpeak NG text-to-speech: 1.52.0  Data at: /usr/share/espeak-ng-data")
    e, je = ew.ESpeak("en"), jew.ESpeak("en")
    assert (e.backend, e.version(), e.language) == (je.backend, je.version(), je.language) == (
        "espeak-ng", "1.52.0", "en-us")
    assert ew.ESpeak.is_available() and ew.detect_espeak_binary() == "espeak-ng"


def test_espeak_symlinked_version_regex(on_path):
    on_path("espeak", "eSpeak NG text-to-speech: 1.50  Data at: /usr/share")
    e, je = ew.ESpeak("en", backend="espeak"), jew.ESpeak("en", backend="espeak")
    assert e.version() == je.version() == "1.50"
    assert [e._ipa_flag(tie=t) for t in (False, True)] == [
        je._ipa_flag(tie=t) for t in (False, True)] == ["--ipa=1", "--ipa=1"]


def test_espeak_old_version_ipa_gate(on_path):
    on_path("espeak", "eSpeak text-to-speech: 1.48.03  04.Mar.14  Data at: /usr/share")
    e, je = ew.ESpeak("en", backend="espeak"), jew.ESpeak("en", backend="espeak")
    assert e.version() == je.version() == "1.48.03"
    assert e._ipa_flag(tie=False) == je._ipa_flag(tie=False) == "--ipa=3"


def test_espeak_language_validation(on_path):
    on_path("espeak-ng", "eSpeak NG text-to-speech: 1.52.0  Data at: /x")
    assert ew.ESpeak("fr").language == jew.ESpeak("fr").language == "fr"
    assert ew.ESpeak("zh-cn").language == jew.ESpeak("zh-cn").language == "cmn"
    with pytest.raises(RuntimeError, match="not supported"):
        ew.ESpeak("xx-nope")


def test_espeak_unknown_backend_rejected(on_path):
    on_path("espeak-ng", "eSpeak NG text-to-speech: 1.52.0  Data at: /x")
    with pytest.raises(ValueError, match="unknown espeak backend"):
        ew.ESpeak("en", backend="festival")


def test_espeak_phonemize_and_tokenizer_route(on_path):
    """Leading separator stripped, (lang) switch flags removed, '_' →
    separator; `Tokenizer()` picks espeak when a binary is on PATH and
    encodes its output as JAX does."""
    on_path("espeak-ng", "eSpeak NG text-to-speech: 1.52.0  Data at: /x",
            phon_out="_h_ə_l_ˈoʊ (en)wˈɜːld(fr)")
    e, je = ew.ESpeak("en"), jew.ESpeak("en")
    out = e.phonemize_espeak("hello world", separator="|")
    assert out == je.phonemize_espeak("hello world", separator="|")
    assert out.startswith("h") and "(en)" not in out and "(fr)" not in out and "|" in out
    tok, jtok = tokenizer.Tokenizer(), jtokenizer.Tokenizer()
    assert isinstance(tok.phonemizer, ew.ESpeak)
    assert tok.text_to_ids("hello world") == jtok.text_to_ids("hello world")
