"""Punctuation strip-and-restore around phonemization (host-side), the
port's copy of `naturalspeech2_tpu/utils/phonemizers/punctuation.py` (the
scheme comes from coqui-TTS): split text at punctuation runs, remember each
run's content and position (BEGIN/END/MIDDLE/ALONE), phonemize the clean
segments, then stitch the punctuation back in.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from enum import Enum
from typing import List, Tuple

DEFAULT_PUNCS = ';:,.!?¡¿—…"«»“”'


class PuncPosition(Enum):
    BEGIN = 0
    END = 1
    MIDDLE = 2
    ALONE = 3


@dataclass
class PuncMark:
    punc: str
    position: PuncPosition


class Punctuation:
    def __init__(self, puncs: str = DEFAULT_PUNCS):
        self.puncs = puncs

    @staticmethod
    def default_puncs() -> str:
        return DEFAULT_PUNCS

    @property
    def puncs(self) -> str:
        return self._puncs

    @puncs.setter
    def puncs(self, value: str):
        assert isinstance(value, str), "punctuations must be a string"
        self._puncs = "".join(dict.fromkeys(value))
        self._regex = re.compile(rf"(\s*[{re.escape(self._puncs)}]+\s*)+")

    def strip(self, text: str) -> str:
        """Replace punctuation runs with spaces and trim."""
        return self._regex.sub(" ", text).strip()

    def strip_to_restore(self, text: str) -> Tuple[List[str], List[PuncMark]]:
        """Split at punctuation runs, keeping a restore map."""
        matches = list(self._regex.finditer(text))
        if not matches:
            return [text], []
        if len(matches) == 1 and matches[0].group() == text:
            return [], [PuncMark(text, PuncPosition.ALONE)]

        marks: List[PuncMark] = []
        segments: List[str] = []
        rest = text
        for i, m in enumerate(matches):
            position = PuncPosition.MIDDLE
            if m is matches[0] and text.startswith(m.group()):
                position = PuncPosition.BEGIN
            elif m is matches[-1] and text.endswith(m.group()):
                position = PuncPosition.END
            marks.append(PuncMark(m.group(), position))

            head, _, tail = rest.partition(m.group())
            segments.append(head)
            if i == len(matches) - 1 and tail:
                segments.append(tail)
            rest = tail
        return segments, marks

    @classmethod
    def restore(cls, segments: List[str], marks: List[PuncMark]) -> List[str]:
        """Inverse of strip_to_restore on (possibly phonemized) segments."""
        if not marks:
            return segments
        if not segments:
            return ["".join(m.punc for m in marks)]

        current, rest = marks[0], marks[1:]
        if current.position == PuncPosition.BEGIN:
            return cls.restore([current.punc + segments[0]] + segments[1:], rest)
        if current.position == PuncPosition.END:
            return [segments[0] + current.punc] + cls.restore(segments[1:], rest)
        if current.position == PuncPosition.ALONE:
            return [current.punc] + cls.restore(segments, rest)
        # MIDDLE
        if len(segments) == 1:
            return cls.restore([segments[0] + current.punc], rest)
        return cls.restore(
            [segments[0] + current.punc + segments[1]] + segments[2:], rest
        )
