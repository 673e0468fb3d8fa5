"""Clock-time expansion (host-side), the port's copy of
`naturalspeech2_tpu/utils/expand/time_norm.py`: ``HH:MM am/pm`` → spoken
words ("9:30 am" → "nine thirty a m", "oh" for minutes < 10), using the
native number-to-words.
"""

from __future__ import annotations

import re

from naturalspeech2_tpu_torch.utils.expand.number_norm import number_to_words

# 0-23 hours, 00-59 minutes, optional am/pm with or without dots. The
# whitespace lives INSIDE the optional group: a bare "5:30 tomorrow" must
# not have its trailing space swallowed into the match (which would glue
# the spoken time to the next word).
_TIME_RE = re.compile(
    r"\b(?P<hour>[01]?\d|2[0-3]):(?P<minute>[0-5]\d)"
    r"(?:\s*(?P<ampm>[ap]\.?m\.?))?\b",
    re.IGNORECASE,
)


def _spoken(match: re.Match, language: str) -> str:
    hour = int(match.group("hour")) % 12 or 12  # 24h → 12h clock, 0 → 12
    words = [number_to_words(hour, language)]

    minute = int(match.group("minute"))
    if minute:
        if minute < 10:
            words.append("oh")
        words.append(number_to_words(minute, language))

    ampm = match.group("ampm")
    if ampm:
        words.extend(ampm.replace(".", ""))  # "pm" → "p m"
    return " ".join(words)


class TimeExpander:
    """Replaces every clock time in the text with its spoken form."""

    def expand_time(self, text: str, language: str = "en") -> str:
        return _TIME_RE.sub(lambda m: _spoken(m, language), text)
