"""Number and currency normalization (host-side), the port's copy of
`naturalspeech2_tpu/utils/expand/number_norm.py`.

The upstream reference delegates to the external `inflect`/`num2words`
packages; number-to-words is implemented natively here (en, fr, es). Keeps
the reference's behaviors: currency regex for $€£¥₹ with per-symbol unit
tables, year-style reading for 2001-2009 ("two thousand five"), and
round-hundreds reading.
"""

from __future__ import annotations

import re
from typing import Dict

_ONES = (
    "zero one two three four five six seven eight nine ten eleven twelve "
    "thirteen fourteen fifteen sixteen seventeen eighteen nineteen"
).split()
_TENS = (
    "zero ten twenty thirty forty fifty sixty seventy eighty ninety"
).split()
_SCALES = [
    (10**12, "trillion"),
    (10**9, "billion"),
    (10**6, "million"),
    (10**3, "thousand"),
    (10**2, "hundred"),
]


def number_to_words_en(n: int) -> str:
    """English cardinal words (inflect-style, with 'and' omitted)."""
    if n < 0:
        return "minus " + number_to_words_en(-n)
    if n < 20:
        return _ONES[n]
    if n < 100:
        tens, ones = divmod(n, 10)
        return _TENS[tens] + ("-" + _ONES[ones] if ones else "")
    for scale, name in _SCALES:
        if n >= scale:
            head, rest = divmod(n, scale)
            words = number_to_words_en(head) + " " + name
            if rest:
                words += " " + number_to_words_en(rest)
            return words
    return _ONES[0]


_FR_ONES = (
    "zéro un deux trois quatre cinq six sept huit neuf dix onze douze treize "
    "quatorze quinze seize dix-sept dix-huit dix-neuf"
).split()
_FR_TENS = ["", "dix", "vingt", "trente", "quarante", "cinquante", "soixante"]


def number_to_words_fr(n: int) -> str:
    if n < 0:
        return "moins " + number_to_words_fr(-n)
    if n < 20:
        return _FR_ONES[n]
    if n < 70:
        tens, ones = divmod(n, 10)
        if ones == 0:
            return _FR_TENS[tens]
        if ones == 1:
            return _FR_TENS[tens] + " et un"
        return _FR_TENS[tens] + "-" + _FR_ONES[ones]
    if n < 80:  # soixante-dix..soixante-dix-neuf
        rest = n - 60
        joiner = " et " if rest == 11 else "-"
        return "soixante" + joiner + _FR_ONES[rest]
    if n < 100:  # quatre-vingt(s)
        rest = n - 80
        if rest == 0:
            return "quatre-vingts"
        return "quatre-vingt-" + number_to_words_fr(rest)
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        head = "cent" if hundreds == 1 else _FR_ONES[hundreds] + " cents"
        if rest == 0:
            return head
        return (head.rstrip("s") if hundreds > 1 else head) + " " + number_to_words_fr(rest)
    if n < 10**6:
        thousands, rest = divmod(n, 1000)
        head = "mille" if thousands == 1 else number_to_words_fr(thousands) + " mille"
        return head if rest == 0 else head + " " + number_to_words_fr(rest)
    millions, rest = divmod(n, 10**6)
    head = (
        "un million" if millions == 1
        else number_to_words_fr(millions) + " millions"
    )
    return head if rest == 0 else head + " " + number_to_words_fr(rest)


_ES_ONES = (
    "cero uno dos tres cuatro cinco seis siete ocho nueve diez once doce "
    "trece catorce quince dieciséis diecisiete dieciocho diecinueve veinte "
    "veintiuno veintidós veintitrés veinticuatro veinticinco veintiséis "
    "veintisiete veintiocho veintinueve"
).split()
_ES_TENS = ["", "", "", "treinta", "cuarenta", "cincuenta", "sesenta",
            "setenta", "ochenta", "noventa"]
_ES_HUNDREDS = ["", "ciento", "doscientos", "trescientos", "cuatrocientos",
                "quinientos", "seiscientos", "setecientos", "ochocientos",
                "novecientos"]


def number_to_words_es(n: int) -> str:
    if n < 0:
        return "menos " + number_to_words_es(-n)
    if n < 30:
        return _ES_ONES[n]
    if n < 100:
        tens, ones = divmod(n, 10)
        if ones == 0:
            return _ES_TENS[tens]
        return _ES_TENS[tens] + " y " + _ES_ONES[ones]
    if n == 100:
        return "cien"
    if n < 1000:
        hundreds, rest = divmod(n, 100)
        head = _ES_HUNDREDS[hundreds]
        return head if rest == 0 else head + " " + number_to_words_es(rest)
    if n < 10**6:
        thousands, rest = divmod(n, 1000)
        head = "mil" if thousands == 1 else number_to_words_es(thousands) + " mil"
        return head if rest == 0 else head + " " + number_to_words_es(rest)
    millions, rest = divmod(n, 10**6)
    head = (
        "un millón" if millions == 1
        else number_to_words_es(millions) + " millones"
    )
    return head if rest == 0 else head + " " + number_to_words_es(rest)


def number_to_words(n: int, language: str = "en") -> str:
    if language == "en" or language is None:
        return number_to_words_en(n)
    if language in ("fr", "fr-fr"):
        return number_to_words_fr(n)
    if language in ("es", "es-es"):
        return number_to_words_es(n)
    raise NotImplementedError(f"number-to-words for language {language!r}")


class NumberNormalizer:
    def __init__(self):
        self._number_re = re.compile(r"-?[0-9]+")
        self._currency_re = re.compile(r"([$€£¥₹])([0-9\,\.]*[0-9]+)")
        self._currencies: Dict[str, Dict[float, str]] = {}

    def add_currency(self, symbol: str, conversion_rates: Dict[float, str]):
        self._currencies[symbol] = conversion_rates

    def normalize_numbers(self, text: str, language: str = "en") -> str:
        text = self._currency_re.sub(self._expand_currency, text)
        text = self._number_re.sub(
            lambda m: self._expand_number(m, language), text
        )
        return text

    def _expand_currency(self, match: re.Match) -> str:
        unit = match.group(1)
        table = self._currencies.get(unit)
        if not table:
            return match.group(0)
        value = match.group(2)
        parts = value.replace(",", "").split(".")
        if len(parts) > 2:
            return f"{value} {table[2]}"
        out = []
        integer = int(parts[0]) if parts[0] else 0
        if integer > 0:
            out.append(f"{integer} {table.get(integer, table[2])}")
        fraction = int(parts[1]) if len(parts) > 1 and parts[1] else 0
        if fraction > 0:
            out.append(f"{fraction} {table.get(fraction / 100, table[0.02])}")
        if not out:
            return f"zero {table[2]}"
        return " ".join(out)

    def _expand_number(self, match: re.Match, language: str) -> str:
        num = int(match.group(0))
        if 1000 < num < 3000:
            if num == 2000:
                return number_to_words(num, language)
            if 2000 < num < 2010:  # "two thousand five"
                return (
                    number_to_words(2000, language)
                    + " "
                    + number_to_words(num % 100, language)
                )
            if num % 100 == 0:
                return number_to_words(num // 100, language) + " hundred"
        return number_to_words(num, language)
