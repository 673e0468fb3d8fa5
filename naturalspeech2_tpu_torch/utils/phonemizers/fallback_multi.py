"""Rule-based Spanish and French G2P for the no-binary fallback path, the
port's copy of `naturalspeech2_tpu/utils/phonemizers/fallback_multi.py`.

The upstream reference demos non-English languages through the espeak
*binary* (fr-fr, hi examples); without a binary these rules stand in.
Spanish orthography is close to phonemic, so rules reach near-lexicon
quality; French rules cover the regular core (nasal vowels, digraphs,
silent finals) — an approximation, clearly below espeak, but
phonotactically sensible.

Conventions: IPA, Latin-American Spanish (seseo, ll/y → ʝ), metropolitan
French without liaison. Stress: Spanish marks ˈ by the standard
vowel/n/s-penultimate rule with written-accent override; French is
phrase-final-stressed, so no lexical mark is emitted.
"""

from __future__ import annotations

import re
import unicodedata

# ------------------------------------------------------------- Spanish

_ES_STRESS_VOWELS = "áéíóú"
_ES_VOWELS = "aeiouáéíóú"


def _es_syllable_nuclei(ipa_parts):
    """Indices of syllable nuclei in the emitted IPA piece list."""
    return [i for i, p in enumerate(ipa_parts) if p and p[0] in "aeiou"]


def spanish_word_to_ipa(word: str) -> str:
    w = word.lower()
    out = []           # ipa pieces, one per emitted phone
    accent_idx = None  # piece index of a written-accent vowel
    i = 0
    n = len(w)
    while i < n:
        c = w[i]
        nxt = w[i + 1] if i + 1 < n else ""
        two = c + nxt
        if two == "ch":
            out.append("tʃ"); i += 2; continue
        if two == "ll":
            out.append("ʝ"); i += 2; continue
        if two == "rr":
            out.append("r"); i += 2; continue
        if two == "qu":
            out.append("k"); i += 2  # u silent; vowel handled next loop
            continue
        if two in ("gu",) and i + 2 < n and w[i + 2] in "ei":
            out.append("ɡ"); i += 2; continue  # silent u
        if c in "áéíóú":
            accent_idx = len(out)
            out.append("aeiou"["áéíóú".index(c)])
            i += 1
            continue
        if c == "ü":
            out.append("w"); i += 1; continue
        mapping = {
            "a": "a", "e": "e", "i": "i", "o": "o", "u": "u",
            "b": "b", "v": "b", "d": "d", "f": "f", "k": "k",
            "l": "l", "m": "m", "n": "n", "ñ": "ɲ", "p": "p",
            "s": "s", "t": "t", "w": "w", "z": "s",
        }
        if c in mapping:
            out.append(mapping[c]); i += 1; continue
        if c == "c":
            out.append("s" if nxt in "ei" else "k"); i += 1; continue
        if c == "g":
            out.append("x" if nxt in "ei" else "ɡ"); i += 1; continue
        if c == "h":
            i += 1; continue  # silent
        if c == "j":
            out.append("x"); i += 1; continue
        if c == "q":
            out.append("k"); i += 1; continue
        if c == "r":
            # word-initial (or after n/l/s) = trill, else tap
            prev = out[-1] if out else ""
            out.append("r" if (not out or prev in ("n", "l", "s")) else "ɾ")
            i += 1; continue
        if c == "x":
            out.append("ks"); i += 1; continue
        if c == "y":
            out.append("i" if i == n - 1 or n == 1 else "ʝ")
            i += 1; continue
        i += 1  # unknown char: drop

    nuclei = _es_syllable_nuclei(out)
    if nuclei:
        if accent_idx is not None and accent_idx in nuclei:
            stress_at = accent_idx
        elif w[-1] in "aeiouns" + _ES_STRESS_VOWELS and len(nuclei) >= 2:
            stress_at = nuclei[-2]  # llana
        else:
            stress_at = nuclei[-1]  # aguda
        if len(nuclei) > 1:
            out[stress_at] = "ˈ" + out[stress_at]
    return "".join(out)


# -------------------------------------------------------------- French

_FR_MULTI = [
    # order matters: longest first
    ("eau", "o"), ("eaux", "o"),
    ("ain", "ɛ̃"), ("aim", "ɛ̃"), ("ein", "ɛ̃"), ("oin", "wɛ̃"),
    ("tion", "sjɔ̃"),
    ("eux", "ø"), ("eu", "ø"), ("œu", "œ"),
    ("ou", "u"), ("oi", "wa"), ("au", "o"), ("ai", "ɛ"), ("ei", "ɛ"),
    ("an", "ɑ̃"), ("am", "ɑ̃"), ("en", "ɑ̃"), ("em", "ɑ̃"),
    ("on", "ɔ̃"), ("om", "ɔ̃"), ("un", "œ̃"), ("um", "œ̃"),
    ("in", "ɛ̃"), ("im", "ɛ̃"), ("yn", "ɛ̃"), ("ym", "ɛ̃"),
    ("ch", "ʃ"), ("ph", "f"), ("gn", "ɲ"), ("qu", "k"), ("gu", "ɡ"),
    ("ill", "ij"), ("ll", "l"), ("ss", "s"), ("ç", "s"),
]

_FR_SINGLE = {
    "a": "a", "à": "a", "â": "ɑ", "b": "b", "d": "d",
    "e": "ə", "é": "e", "è": "ɛ", "ê": "ɛ", "ë": "ɛ",
    "f": "f", "i": "i", "î": "i", "ï": "i", "j": "ʒ", "k": "k",
    "l": "l", "m": "m", "n": "n", "o": "ɔ", "ô": "o", "p": "p",
    "r": "ʁ", "t": "t", "u": "y", "û": "y", "ù": "y",
    "v": "v", "w": "w", "y": "i", "z": "z",
}


def french_word_to_ipa(word: str) -> str:
    w = word.lower()
    # -er infinitive/agent ending → /e/
    w = re.sub(r"er$", "é", w) if len(w) > 3 else w
    # silent final letters: mute e(s), then a single final consonant —
    # keep n/m (they nasalize the preceding vowel) and r/f/l ("careful")
    w = re.sub(r"(es|e)$", "", w) if len(w) > 2 else w
    w = re.sub(r"[tdspxz]$", "", w) if len(w) > 2 else w
    w = re.sub(r"(?<=n)[cg]$", "", w)  # blanc → blan, sang → san
    out = []
    i = 0
    n = len(w)
    while i < n:
        matched = False
        # nasal digraphs only bind when NOT followed by a vowel/m/n
        for graph, ipa in _FR_MULTI:
            if w.startswith(graph, i):
                if graph in ("an", "am", "en", "em", "on", "om", "un",
                             "um", "in", "im", "yn", "ym", "ain", "aim",
                             "ein", "oin"):
                    after = w[i + len(graph):i + len(graph) + 1]
                    if after and after in "aeiouéèêëîïôûùy" + "mn":
                        continue  # vowel follows: not nasal
                out.append(ipa)
                i += len(graph)
                matched = True
                break
        if matched:
            continue
        c = w[i]
        nxt = w[i + 1] if i + 1 < n else ""
        if c == "c":
            out.append("s" if nxt in "eiéèêy" else "k"); i += 1; continue
        if c == "g":
            out.append("ʒ" if nxt in "eiéèêy" else "ɡ"); i += 1; continue
        if c == "h":
            i += 1; continue
        if c == "s":
            # intervocalic s → z
            prev = w[i - 1] if i else ""
            out.append("z" if (prev in "aeiouéèêëîïôûù"
                               and nxt in "aeiouéèêëîïôûù") else "s")
            i += 1; continue
        if c == "x":
            out.append("ks"); i += 1; continue
        if c in _FR_SINGLE:
            out.append(_FR_SINGLE[c]); i += 1; continue
        i += 1
    return "".join(out)


# ------------------------------------------------------------- routing

_WORD_RE = re.compile(r"[^\W\d_]+(?:'[^\W\d_]+)?", re.UNICODE)


def phonemize_text(text: str, language: str, separator: str = "") -> str:
    """Language-routed rule G2P over whitespace/punct-split words."""
    lang = language.split("-")[0].lower()
    if lang == "es":
        fn = spanish_word_to_ipa
    elif lang == "fr":
        fn = french_word_to_ipa
    else:
        raise ValueError(f"no rule G2P for language {language!r}")
    words = _WORD_RE.findall(unicodedata.normalize("NFC", text))
    sep = separator or ""
    return " ".join(
        sep.join(fn(wd)) if sep else fn(wd) for wd in words
    )
