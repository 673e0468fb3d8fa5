"""espeak / espeak-ng subprocess G2P (host-side), the port's copy of
`naturalspeech2_tpu/utils/phonemizers/espeak_wrapper.py`.

Auto-detects espeak-ng (preferred) or espeak, parses the binary version
(espeak may be symlinked to espeak-ng, which moves the version bits — the
upstream reference's regex handles that, :20-29), gates the ``--ipa`` flag
on the version (:168-188), validates languages against ``--voices``
(:215-236), strips version-specific leading separators and language-switch
flags from the output. Phonemization stays a host-side subprocess, as in
the reference pipeline.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from typing import Dict, List, Optional, Tuple

from naturalspeech2_tpu_torch.utils.phonemizers.base import BasePhonemizer
from naturalspeech2_tpu_torch.utils.phonemizers.punctuation import Punctuation

# espeak may be a symlink to espeak-ng, which moves the version bits to
# another token — match the stable "text-to-speech: X.Y[.Z]" form instead
_ESPEAK_VERSION_PATTERN = re.compile(
    r"text-to-speech:\s(?P<version>\d+\.\d+(\.\d+)?)"
)


def _which(name: str) -> bool:
    return shutil.which(name) is not None


def detect_espeak_binary() -> Optional[str]:
    """espeak-ng preferred over espeak (reference :37-45)."""
    for binary in ("espeak-ng", "espeak"):
        if _which(binary):
            return binary
    return None


def _run_espeak(binary: str, args: List[str]) -> List[str]:
    cmd = [binary, "-q", "-b", "1", *args]
    out = subprocess.run(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, check=False
    )
    return out.stdout.decode("utf8").splitlines()


def get_espeak_version(binary: str = "espeak") -> str:
    """Version of a (possibly symlinked) espeak binary (reference :25-29)."""
    for line in _run_espeak(binary, ["--version"]):
        match = _ESPEAK_VERSION_PATTERN.search(line)
        if match:
            return match.group("version")
    return "unknown"


def get_espeakng_version(binary: str = "espeak-ng") -> str:
    """espeak-ng prints 'eSpeak NG text-to-speech: <ver>  Data at: …'
    (reference :32-34)."""
    for line in _run_espeak(binary, ["--version"]):
        parts = line.strip().split()
        if len(parts) > 3:
            return parts[3]
    return "unknown"


def _version_tuple(version: str) -> Tuple[int, ...]:
    try:
        return tuple(int(p) for p in version.split("."))
    except ValueError:
        return (0,)


class ESpeak(BasePhonemizer):
    """Subprocess G2P through espeak/espeak-ng, coqui-compatible output
    cleanup (leading separator chars, ``(lang)`` switch flags)."""

    # cached --voices table per binary (ctor-time language validation
    # without re-running the subprocess per instance)
    _LANG_CACHE: Dict[str, Dict[str, str]] = {}

    def __init__(
        self,
        language: str,
        backend: Optional[str] = None,
        punctuations: str = Punctuation.default_puncs(),
        keep_puncs: bool = True,
    ):
        resolved = backend or detect_espeak_binary()
        if resolved is None:
            raise RuntimeError(
                "no espeak backend found — install espeak-ng or espeak, or "
                "use the pure-python fallback phonemizer "
                "(naturalspeech2_tpu_torch.utils.phonemizers.fallback.RuleBasedG2P)"
            )
        if resolved not in ("espeak", "espeak-ng"):
            raise ValueError(f"unknown espeak backend: {resolved!r}")
        self.backend = resolved
        self.backend_version = (
            get_espeakng_version(resolved)
            if resolved == "espeak-ng"
            else get_espeak_version(resolved)
        )
        # band-aid remaps for backwards compatibility (reference :118-122)
        if language == "en":
            language = "en-us"
        if language == "zh-cn":
            language = "cmn"
        super().__init__(language, punctuations=punctuations, keep_puncs=keep_puncs)

    @staticmethod
    def name() -> str:
        return "espeak"

    @classmethod
    def is_available(cls) -> bool:
        return detect_espeak_binary() is not None

    def version(self) -> str:
        return self.backend_version

    def is_supported_language(self, language: str) -> bool:
        """Validate against the binary's ``--voices`` table (reference
        base.py:86-88 + espeak_wrapper.py:215-236); permissive when the
        table cannot be read."""
        langs = self._voices_table(self.backend)
        if not langs:
            return True
        return language in langs

    @classmethod
    def _voices_table(cls, binary: Optional[str]) -> Dict[str, str]:
        if binary is None:
            return {}
        if binary not in cls._LANG_CACHE:
            langs: Dict[str, str] = {}
            try:
                for i, line in enumerate(_run_espeak(binary, ["--voices"])):
                    if i == 0:
                        continue
                    cols = line.split()
                    if len(cols) >= 4:
                        langs[cols[1]] = cols[3]
            except OSError:
                pass
            cls._LANG_CACHE[binary] = langs
        return cls._LANG_CACHE[binary]

    @staticmethod
    def supported_languages() -> Dict[str, str]:
        return ESpeak._voices_table(detect_espeak_binary())

    def _ipa_flag(self, tie: bool) -> str:
        """Version-gated --ipa selection (reference :168-188): espeak-ng
        splits phonemes with '_' at --ipa=1 and ties at --ipa=3; classic
        espeak older than 1.48.15 needs --ipa=3 for the '_' split."""
        if tie:
            return "--ipa=1" if self.backend == "espeak" else "--ipa=3"
        if self.backend == "espeak":
            if _version_tuple(self.backend_version) >= (1, 48, 15):
                return "--ipa=1"
            return "--ipa=3"
        return "--ipa=1"

    def phonemize_espeak(self, text: str, separator: str = "|", tie: bool = False) -> str:
        args = ["-v", self._language, self._ipa_flag(tie)]
        if tie:
            args.append("--tie=͡")
        args.append(f'"{text}"')

        phonemes = ""
        for line in _run_espeak(self.backend, args):
            decoded = line.strip()
            # drop the version-dependent leading separator character
            decoded = decoded[:1].replace("_", "") + decoded[1:]
            # remove (lang) switch flags espeak-ng inserts
            decoded = re.sub(r"\(.+?\)", "", decoded)
            phonemes += decoded.strip()
        return phonemes.replace("_", separator)

    def _phonemize(self, text: str, separator: str = "") -> str:
        return self.phonemize_espeak(text, separator, tie=False)
