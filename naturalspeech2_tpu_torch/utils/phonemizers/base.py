"""Abstract phonemizer (host-side), the port's copy of
`naturalspeech2_tpu/utils/phonemizers/base.py`: availability + language
checks, then preprocess (strip punctuation) → ``_phonemize`` → postprocess
(restore).
"""

from __future__ import annotations

import abc
from typing import List, Tuple

from naturalspeech2_tpu_torch.utils.phonemizers.punctuation import Punctuation


class BasePhonemizer(abc.ABC):
    def __init__(self, language, punctuations=Punctuation.default_puncs(),
                 keep_puncs: bool = False):
        if not self.is_available():
            raise RuntimeError(
                f"{self.name()} not installed on your system"
            )
        self._language = self._init_language(language)
        self._keep_puncs = keep_puncs
        self._punctuator = Punctuation(punctuations)

    def _init_language(self, language):
        if not self.is_supported_language(language):
            raise RuntimeError(
                f'language "{language}" is not supported by the {self.name()} backend'
            )
        return language

    @property
    def language(self):
        return self._language

    @staticmethod
    @abc.abstractmethod
    def name() -> str: ...

    @classmethod
    @abc.abstractmethod
    def is_available(cls) -> bool: ...

    @classmethod
    @abc.abstractmethod
    def version(cls) -> str: ...

    @staticmethod
    @abc.abstractmethod
    def supported_languages() -> dict: ...

    def is_supported_language(self, language: str) -> bool:
        return language in self.supported_languages()

    @abc.abstractmethod
    def _phonemize(self, text: str, separator: str) -> str: ...

    def _phonemize_preprocess(self, text: str) -> Tuple[List[str], List]:
        text = text.strip()
        if self._keep_puncs:
            return self._punctuator.strip_to_restore(text)
        return [self._punctuator.strip(text)], []

    def _phonemize_postprocess(self, phonemized: List[str], punctuations) -> str:
        if self._keep_puncs:
            return "".join(self._punctuator.restore(phonemized, punctuations))
        return phonemized[0]

    def phonemize(self, text: str, separator: str = "|", language: str = None) -> str:
        segments, puncs = self._phonemize_preprocess(text)
        phonemized = [self._phonemize(seg, separator) for seg in segments]
        return self._phonemize_postprocess(phonemized, puncs)
