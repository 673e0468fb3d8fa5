"""Text cleaning pipeline (host-side), the port's copy of
`naturalspeech2_tpu/utils/cleaner.py`: ``phoneme_cleaners`` = expand time →
normalize numbers/currency → expand abbreviations → strip aux symbols
``<>()[]"`` → collapse whitespace.
"""

from __future__ import annotations

import re
from typing import Optional

from naturalspeech2_tpu_torch.utils.expand.abbreviations import AbbreviationExpander
from naturalspeech2_tpu_torch.utils.expand.number_norm import NumberNormalizer
from naturalspeech2_tpu_torch.utils.expand.time_norm import TimeExpander


class TextProcessor:
    def __init__(self, lang: str = "en", abbreviations_file: Optional[str] = None):
        self.lang = lang
        self._whitespace_re = re.compile(r"\s+")
        self.ab_expander = AbbreviationExpander(abbreviations_file)
        self.time_expander = TimeExpander()
        self.num_normalizer = NumberNormalizer()
        self.num_normalizer.add_currency(
            "$", {0.01: "cent", 0.02: "cents", 1: "dollar", 2: "dollars"}
        )

    def lowercase(self, text: str) -> str:
        return text.lower()

    def collapse_whitespace(self, text: str) -> str:
        return self._whitespace_re.sub(" ", text).strip()

    def remove_aux_symbols(self, text: str) -> str:
        return re.sub(r"[\<\>\(\)\[\]\"]+", "", text)

    def phoneme_cleaners(self, text: str, language: str = "en") -> str:
        text = self.time_expander.expand_time(text, language=language)
        text = self.num_normalizer.normalize_numbers(text, language=language)
        text = self.ab_expander.replace_text_abbreviations(text, language=language)
        text = self.remove_aux_symbols(text)
        text = self.collapse_whitespace(text)
        return text
