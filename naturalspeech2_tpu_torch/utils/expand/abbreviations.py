"""Abbreviation expansion (host-side text normalization), the port's copy
of `naturalspeech2_tpu/utils/expand/abbreviations.py`.

Per-language case-insensitive whole-word regex substitution, as the upstream
reference's CSV-driven expander does. The standard en/fr/es abbreviation
tables ship as Python data; a custom CSV (columns
abbreviation,expansion,language) can be loaded on top.
"""

from __future__ import annotations

import csv
import re
from typing import Dict, Optional

_BUILTIN: Dict[str, Dict[str, str]] = {
    "en": {
        "mr.": "mister", "mrs.": "misess", "ms.": "miss", "dr.": "doctor",
        "drs.": "doctors", "st.": "saint", "co.": "company", "jr.": "junior",
        "sr.": "senior", "maj.": "major", "gen.": "general", "rev.": "reverend",
        "lt.": "lieutenant", "hon.": "honorable", "sgt.": "sergeant",
        "capt.": "captain", "esq.": "esquire", "ltd.": "limited",
        "col.": "colonel", "ft.": "fort", "dept.": "department",
        "prof.": "professor", "ave.": "avenue", "blvd.": "boulevard",
        "rd.": "road", "inc.": "incorporated", "corp.": "corporation",
        "intl.": "international", "etc.": "et cetera", "no.": "number",
        "vs.": "versus",
    },
    "fr": {
        "m.": "monsieur", "mme.": "madame", "mlle.": "mademoiselle",
        "dr.": "docteur", "st.": "saint", "ste.": "sainte", "av.": "avenue",
        "bd.": "boulevard", "etc.": "et cetera", "no.": "numéro",
    },
    "es": {
        "sr.": "señor", "sra.": "señora", "srta.": "señorita",
        "dr.": "doctor", "dra.": "doctora", "av.": "avenida",
        "gral.": "general", "etc.": "etcétera", "no.": "número",
    },
}


class AbbreviationExpander:
    def __init__(self, abbreviations_file: Optional[str] = None):
        self.abbreviations: Dict[str, Dict[str, str]] = {
            lang: dict(table) for lang, table in _BUILTIN.items()
        }
        if abbreviations_file:
            self.load_abbreviations(abbreviations_file)
        self._compile()

    def load_abbreviations(self, path: str):
        with open(path, newline="") as f:
            for row in csv.DictReader(f):
                lang = row["language"].lower()
                self.abbreviations.setdefault(lang, {})[
                    row["abbreviation"].lower()
                ] = row["expansion"]
        self._compile()

    def _compile(self):
        self.patterns = {
            lang: re.compile(
                r"\b("
                + "|".join(re.escape(k) for k in sorted(table, key=len, reverse=True))
                + r")(?!\w)",
                re.IGNORECASE,
            )
            for lang, table in self.abbreviations.items()
            if table
        }

    def replace_text_abbreviations(self, text: str, language: str = "en") -> str:
        lang = language.lower()
        pattern = self.patterns.get(lang)
        if pattern is None:
            return text
        return pattern.sub(
            lambda m: self.abbreviations[lang][m.group(0).lower()], text
        )
