"""IPA phoneme tokenizer (host-side), the port's copy of
`naturalspeech2_tpu/utils/tokenizer.py`: IPA character vocabulary (122
phoneme chars), char↔id maps, clean → phonemize → encode, batch padding
with ``pad_id=-1``. It returns numpy; `sample` and the serving engine move
the ids to the device.

Defects of the upstream reference fixed as the JAX package fixes them: its
blank/BOS-EOS paths reference a nonexistent ``self.characters`` (:146,
:153) — here blank, bos and eos are real, appended vocabulary entries; and
``LANGUAGE_MAP`` maps ``fr-fr → fr`` rather than the reference's
``'fr-fr': 'es'`` quirk (:24).
"""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from naturalspeech2_tpu_torch.utils.cleaner import TextProcessor

# default IPA phoneme inventory (matches the reference's character set:
# vowels, pulmonic/non-pulmonic consonants, suprasegmentals, other symbols,
# diacritics — tokenizer.py:12-18)
_vowels = "iyɨʉɯuɪʏʊeøɘəɵɤoɛœɜɞʌɔæɐaɶɑɒᵻ"
_non_pulmonic_consonants = "ʘɓǀɗǃʄǂɠǁʛ"
_pulmonic_consonants = "pbtdʈɖcɟkɡqɢʔɴŋɲɳnɱmʙrʀⱱɾɽɸβfvθðszʃʒʂʐçʝxɣχʁħʕhɦɬɮʋɹɻjɰlɭʎʟ"
_suprasegmentals = "'̃ˈˌːˑ. ,-"
_other_symbols = "ʍwɥʜʢʡɕʑɺɧʲ"
_diacrilics = "ɚ˞ɫ"
DEFAULT_PHONEMES = (
    _vowels
    + _non_pulmonic_consonants
    + _pulmonic_consonants
    + _suprasegmentals
    + _other_symbols
    + _diacrilics
)

LANGUAGE_MAP = {
    "en-us": "en",
    "fr-fr": "fr",
    "hi": "hi",
}

BLANK_CHAR = "<blnk>"
BOS_CHAR = "<bos>"
EOS_CHAR = "<eos>"


class Tokenizer:
    def __init__(
        self,
        vocab: str = DEFAULT_PHONEMES,
        text_cleaner: Optional[Callable] = None,
        phonemizer=None,
        default_lang: str = "en-us",
        add_blank: bool = False,
        use_eos_bos: bool = False,
        pad_id: int = -1,
    ):
        self.text_cleaner = text_cleaner or TextProcessor().phoneme_cleaners
        self.add_blank = add_blank
        self.use_eos_bos = use_eos_bos
        self.pad_id = pad_id

        self.vocab = list(vocab)
        # special tokens live at the end so base IPA ids match the reference
        self.blank_id = len(self.vocab)
        self.bos_id = len(self.vocab) + 1
        self.eos_id = len(self.vocab) + 2
        self.char_to_id = {c: i for i, c in enumerate(self.vocab)}
        self.char_to_id[BLANK_CHAR] = self.blank_id
        self.char_to_id[BOS_CHAR] = self.bos_id
        self.char_to_id[EOS_CHAR] = self.eos_id
        self.id_to_char = {i: c for c, i in self.char_to_id.items()}

        if phonemizer is None:
            from naturalspeech2_tpu_torch.utils.phonemizers.fallback import (
                default_phonemizer,
            )

            phonemizer = default_phonemizer(language=default_lang)
        self.phonemizer = phonemizer
        self.language = self.phonemizer.language
        self.not_found_characters: List[str] = []

    @property
    def vocab_size(self) -> int:
        # base phoneme inventory + blank + bos + eos
        return len(self.vocab) + 3

    @property
    def espeak_language(self) -> Optional[str]:
        return LANGUAGE_MAP.get(self.language)

    def encode(self, text) -> List[int]:
        """Chars (or special-token strings) → ids; unknown chars are dropped
        and logged once (reference :71-84)."""
        ids = []
        for char in text:
            idx = self.char_to_id.get(char)
            if idx is not None:
                ids.append(idx)
            elif char not in self.not_found_characters:
                self.not_found_characters.append(char)
                print(
                    f" [!] Character {char!r} not found in the vocabulary. "
                    "Discarding it."
                )
        return ids

    def decode(self, token_ids: List[int]) -> str:
        return "".join(self.id_to_char[i] for i in token_ids)

    def intersperse_blank_char(self, chars: List[str]) -> List[str]:
        result = [BLANK_CHAR] * (len(chars) * 2 + 1)
        result[1::2] = chars
        return result

    def pad_with_bos_eos(self, chars: List[str]) -> List[str]:
        return [BOS_CHAR, *chars, EOS_CHAR]

    def text_to_ids(
        self, text: str, language: Optional[str] = None
    ) -> Tuple[List[int], Optional[str], str]:
        """clean → phonemize → [blank/bos-eos] → ids. Returns
        (ids, cleaned_text, phonemized) like the reference (:93-129)."""
        language = language or self.espeak_language
        cleaned = None
        if self.text_cleaner is not None:
            text = self.text_cleaner(text, language=language or "en")
            cleaned = text
        phonemized = self.phonemizer.phonemize(text, separator="", language=language)
        sequence: List[str] = list(phonemized)
        if self.add_blank:
            sequence = self.intersperse_blank_char(sequence)
        if self.use_eos_bos:
            sequence = self.pad_with_bos_eos(sequence)
        return self.encode(sequence), cleaned, phonemized

    def texts_to_tensor_ids(
        self, texts: List[str], language: Optional[str] = None
    ) -> np.ndarray:
        """Batch of texts → ``[b, max_len]`` int32, padded with pad_id
        (reference :131-138). Returns numpy for host→device transfer."""
        all_ids = [self.text_to_ids(t, language=language)[0] for t in texts]
        max_len = max(len(ids) for ids in all_ids)
        out = np.full((len(all_ids), max_len), self.pad_id, dtype=np.int32)
        for i, ids in enumerate(all_ids):
            out[i, : len(ids)] = ids
        return out

    def ids_to_text(self, id_sequence: List[int]) -> str:
        return self.decode(id_sequence)
