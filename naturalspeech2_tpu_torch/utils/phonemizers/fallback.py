"""Pure-Python rule-based English G2P fallback (host-side), the port's
copy of `naturalspeech2_tpu/utils/phonemizers/fallback.py`.

The upstream reference delegates G2P entirely to the external espeak binary
(`espeak_wrapper.py`); when no such binary exists on the host, this module
provides an approximate English grapheme→IPA conversion so the full
text→audio pipeline remains functional:

- a ~400-word GenAm lexicon covering function words, auxiliaries, numbers
  (including every word the `NumberNormalizer` can emit — twenty, thirty,
  hundred, thousand, million, …), days, months and frequent content words;
- suffix morphology: ``-s/-es`` (voicing-sensitive), ``-ed`` (t/d/ɪd),
  ``-ing``, ``-ly``, ``-er``, ``-est``, ``-ness``, ``-ment``, ``-ful``
  recurse on the stem so inflected forms reuse lexicon entries;
- letter-to-sound rules with magic-e vowel lengthening ("make" → meɪk).

Output is restricted to the tokenizer's IPA vocabulary. For
production-quality phonemization, install espeak-ng.
"""

from __future__ import annotations

import re
from typing import Dict, Optional

from naturalspeech2_tpu_torch.utils.phonemizers.base import BasePhonemizer
from naturalspeech2_tpu_torch.utils.phonemizers.punctuation import Punctuation

# GenAm IPA lexicon. Stress marks (ˈ, ˌ) are part of the tokenizer vocab.
_LEXICON: Dict[str, str] = {
    # articles / pronouns / determiners
    "a": "ə", "an": "ən", "the": "ðə", "i": "ˈaɪ", "you": "juː",
    "he": "hiː", "she": "ʃiː", "we": "wiː", "they": "ðeɪ", "it": "ɪt",
    "me": "miː", "him": "hɪm", "her": "hɜːɹ", "us": "ʌs", "them": "ðɛm",
    "my": "maɪ", "your": "jɔːɹ", "his": "hɪz", "its": "ɪts", "our": "aʊɚ",
    "their": "ðɛɹ", "mine": "maɪn", "yours": "jɔːɹz", "this": "ðɪs",
    "that": "ðæt", "these": "ðiːz", "those": "ðoʊz", "which": "wɪtʃ",
    "each": "iːtʃ", "every": "ˈɛvɹi", "some": "sʌm", "any": "ˈɛni",
    "many": "ˈmɛni", "much": "mʌtʃ", "few": "fjuː", "all": "ɔːl",
    "both": "boʊθ", "other": "ˈʌðɚ", "another": "əˈnʌðɚ", "such": "sʌtʃ",
    "own": "oʊn", "same": "seɪm", "more": "mɔːɹ", "most": "moʊst",
    "less": "lɛs", "least": "liːst", "none": "nʌn", "something": "ˈsʌmθɪŋ",
    "nothing": "ˈnʌθɪŋ", "everything": "ˈɛvɹiθɪŋ", "anything": "ˈɛniθɪŋ",
    "someone": "ˈsʌmwʌn", "everyone": "ˈɛvɹiwʌn", "anyone": "ˈɛniwʌn",
    # be / auxiliaries
    "is": "ɪz", "are": "ɑːɹ", "was": "wʌz", "were": "wɜːɹ", "be": "biː",
    "been": "bɪn", "being": "ˈbiːɪŋ", "am": "æm", "have": "hæv",
    "has": "hæz", "had": "hæd", "do": "duː", "does": "dʌz", "did": "dɪd",
    "done": "dʌn", "will": "wɪl", "would": "wʊd", "can": "kæn",
    "could": "kʊd", "shall": "ʃæl", "should": "ʃʊd", "may": "meɪ",
    "might": "maɪt", "must": "mʌst", "ought": "ɔːt", "need": "niːd",
    "dont": "doʊnt", "cant": "kænt", "wont": "woʊnt", "isnt": "ˈɪzənt",
    "im": "aɪm", "ive": "aɪv", "id": "aɪd", "ill": "aɪl",
    "youre": "jʊɹ", "theyre": "ðɛɹ", "hes": "hiːz", "shes": "ʃiːz",
    "we're": "wɪɹ", "lets": "lɛts", "thats": "ðæts", "whats": "wʌts",
    # prepositions / conjunctions
    "to": "tuː", "of": "ʌv", "in": "ɪn", "on": "ɑːn", "at": "æt",
    "by": "baɪ", "for": "fɔːɹ", "with": "wɪð", "without": "wɪðˈaʊt",
    "from": "fɹʌm", "into": "ˈɪntuː", "onto": "ˈɑːntuː", "about": "əˈbaʊt",
    "against": "əˈɡɛnst", "between": "bɪˈtwiːn", "among": "əˈmʌŋ",
    "through": "θɹuː", "during": "ˈdʊɹɪŋ", "before": "bɪˈfɔːɹ",
    "after": "ˈæftɚ", "above": "əˈbʌv", "below": "bɪˈloʊ",
    "under": "ˈʌndɚ", "over": "ˈoʊvɚ", "again": "əˈɡɛn",
    "and": "ænd", "or": "ɔːɹ", "but": "bʌt", "if": "ɪf", "then": "ðɛn",
    "else": "ɛls", "because": "bɪˈkɔz", "while": "waɪl", "since": "sɪns",
    "until": "ənˈtɪl", "although": "ɔːlˈðoʊ", "though": "ðoʊ",
    "however": "haʊˈɛvɚ", "therefore": "ˈðɛɹfɔːɹ", "so": "soʊ",
    "as": "æz", "than": "ðæn", "too": "tuː", "also": "ˈɔːlsoʊ",
    "not": "nɑːt", "no": "noʊ", "nor": "nɔːɹ", "yes": "jɛs",
    "very": "ˈvɛɹi", "just": "dʒʌst", "only": "ˈoʊnli", "even": "ˈiːvən",
    "still": "stɪl", "already": "ɔːlˈɹɛdi", "almost": "ˈɔːlmoʊst",
    "always": "ˈɔːlweɪz", "never": "ˈnɛvɚ", "often": "ˈɔːfən",
    "sometimes": "ˈsʌmtaɪmz", "usually": "ˈjuːʒuəli", "perhaps": "pɚˈhæps",
    "maybe": "ˈmeɪbi", "really": "ˈɹɪli", "quite": "kwaɪt",
    "rather": "ˈɹæðɚ", "together": "təˈɡɛðɚ", "away": "əˈweɪ",
    "back": "bæk", "here": "hɪɹ", "there": "ðɛɹ", "everywhere": "ˈɛvɹiwɛɹ",
    # questions
    "what": "wʌt", "who": "huː", "whom": "huːm", "whose": "huːz",
    "how": "haʊ", "when": "wɛn", "where": "wɛɹ", "why": "waɪ",
    # numbers — everything NumberNormalizer can emit
    "zero": "ˈzɪɹoʊ", "oh": "oʊ", "one": "wʌn", "two": "tuː",
    "three": "θɹiː", "four": "fɔːɹ", "five": "faɪv", "six": "sɪks",
    "seven": "ˈsɛvən", "eight": "eɪt", "nine": "naɪn", "ten": "tɛn",
    "eleven": "ɪˈlɛvən", "twelve": "twɛlv", "thirteen": "θɜːɹˈtiːn",
    "fourteen": "fɔːɹˈtiːn", "fifteen": "fɪfˈtiːn", "sixteen": "sɪksˈtiːn",
    "seventeen": "sɛvənˈtiːn", "eighteen": "eɪˈtiːn", "nineteen": "naɪnˈtiːn",
    "twenty": "ˈtwɛnti", "thirty": "ˈθɜːɹti", "forty": "ˈfɔːɹti",
    "fifty": "ˈfɪfti", "sixty": "ˈsɪksti", "seventy": "ˈsɛvənti",
    "eighty": "ˈeɪti", "ninety": "ˈnaɪnti", "hundred": "ˈhʌndɹəd",
    "thousand": "ˈθaʊzənd", "million": "ˈmɪljən", "billion": "ˈbɪljən",
    "trillion": "ˈtɹɪljən", "first": "fɜːɹst", "second": "ˈsɛkənd",
    "third": "θɜːɹd", "fifth": "fɪfθ", "ninth": "naɪnθ",
    "twelfth": "twɛlfθ", "half": "hæf", "quarter": "ˈkwɔːɹtɚ",
    "point": "pɔɪnt", "minus": "ˈmaɪnəs", "percent": "pɚˈsɛnt",
    "dollar": "ˈdɑːlɚ", "dollars": "ˈdɑːlɚz", "cent": "sɛnt",
    "cents": "sɛnts", "euro": "ˈjʊɹoʊ", "euros": "ˈjʊɹoʊz",
    "pound": "paʊnd", "pounds": "paʊndz",
    # time
    "time": "taɪm", "oclock": "əˈklɑːk", "clock": "klɑːk",
    "today": "təˈdeɪ", "tomorrow": "təˈmɑːɹoʊ", "yesterday": "ˈjɛstɚdeɪ",
    "morning": "ˈmɔːɹnɪŋ", "evening": "ˈiːvnɪŋ", "afternoon": "æftɚˈnuːn",
    "night": "naɪt", "day": "deɪ", "week": "wiːk", "month": "mʌnθ",
    "year": "jɪɹ", "hour": "aʊɚ", "minute": "ˈmɪnɪt", "moment": "ˈmoʊmənt",
    "monday": "ˈmʌndeɪ", "tuesday": "ˈtuːzdeɪ", "wednesday": "ˈwɛnzdeɪ",
    "thursday": "ˈθɜːɹzdeɪ", "friday": "ˈfɹaɪdeɪ", "saturday": "ˈsætɚdeɪ",
    "sunday": "ˈsʌndeɪ", "january": "ˈdʒænjuɛɹi", "february": "ˈfɛbɹuɛɹi",
    "march": "mɑːɹtʃ", "april": "ˈeɪpɹəl", "june": "dʒuːn",
    "july": "dʒuˈlaɪ", "august": "ˈɔːɡəst", "september": "sɛpˈtɛmbɚ",
    "october": "ɑːkˈtoʊbɚ", "november": "noʊˈvɛmbɚ", "december": "dɪˈsɛmbɚ",
    # common verbs
    "go": "ɡoʊ", "goes": "ɡoʊz", "going": "ˈɡoʊɪŋ", "went": "wɛnt",
    "gone": "ɡɔːn", "come": "kʌm", "came": "keɪm", "get": "ɡɛt",
    "got": "ɡɑːt", "make": "meɪk", "made": "meɪd", "take": "teɪk",
    "took": "tʊk", "taken": "ˈteɪkən", "give": "ɡɪv", "gave": "ɡeɪv",
    "given": "ˈɡɪvən", "know": "noʊ", "knew": "nuː", "known": "noʊn",
    "think": "θɪŋk", "thought": "θɔːt", "say": "seɪ", "says": "sɛz",
    "said": "sɛd", "see": "siː", "saw": "sɔː", "seen": "siːn",
    "look": "lʊk", "want": "wɑːnt", "use": "juːz", "used": "juːzd",
    "find": "faɪnd", "found": "faʊnd", "tell": "tɛl", "told": "toʊld",
    "ask": "æsk", "work": "wɜːɹk", "seem": "siːm", "feel": "fiːl",
    "felt": "fɛlt", "try": "tɹaɪ", "leave": "liːv", "left": "lɛft",
    "call": "kɔːl", "keep": "kiːp", "kept": "kɛpt", "let": "lɛt",
    "begin": "bɪˈɡɪn", "began": "bɪˈɡæn", "begun": "bɪˈɡʌn",
    "show": "ʃoʊ", "hear": "hɪɹ", "heard": "hɜːɹd", "play": "pleɪ",
    "run": "ɹʌn", "ran": "ɹæn", "move": "muːv", "live": "lɪv",
    "believe": "bɪˈliːv", "bring": "bɹɪŋ", "brought": "bɹɔːt",
    "happen": "ˈhæpən", "write": "ɹaɪt", "wrote": "ɹoʊt",
    "written": "ˈɹɪtən", "read": "ɹiːd", "sit": "sɪt", "sat": "sæt",
    "stand": "stænd", "stood": "stʊd", "lose": "luːz", "lost": "lɔːst",
    "pay": "peɪ", "paid": "peɪd", "meet": "miːt", "met": "mɛt",
    "include": "ɪnˈkluːd", "continue": "kənˈtɪnjuː", "set": "sɛt",
    "learn": "lɜːɹn", "change": "tʃeɪndʒ", "lead": "liːd", "led": "lɛd",
    "understand": "ʌndɚˈstænd", "understood": "ʌndɚˈstʊd",
    "watch": "wɑːtʃ", "follow": "ˈfɑːloʊ", "stop": "stɑːp",
    "create": "kɹiˈeɪt", "speak": "spiːk", "spoke": "spoʊk",
    "spoken": "ˈspoʊkən", "listen": "ˈlɪsən", "open": "ˈoʊpən",
    "close": "kloʊz", "walk": "wɔːk", "win": "wɪn", "won": "wʌn",
    "offer": "ˈɔːfɚ", "remember": "ɹɪˈmɛmbɚ", "love": "lʌv",
    "consider": "kənˈsɪdɚ", "appear": "əˈpɪɹ", "buy": "baɪ",
    "bought": "bɔːt", "wait": "weɪt", "serve": "sɜːɹv", "die": "daɪ",
    "send": "sɛnd", "sent": "sɛnt", "expect": "ɪkˈspɛkt",
    "build": "bɪld", "built": "bɪlt", "stay": "steɪ", "fall": "fɔːl",
    "fell": "fɛl", "cut": "kʌt", "reach": "ɹiːtʃ", "kill": "kɪl",
    "remain": "ɹɪˈmeɪn", "eat": "iːt", "ate": "eɪt", "eaten": "ˈiːtən",
    "drink": "dɹɪŋk", "sleep": "sliːp", "thank": "θæŋk",
    "thanks": "θæŋks", "please": "pliːz", "sorry": "ˈsɑːɹi",
    "welcome": "ˈwɛlkəm", "hello": "həˈloʊ", "hi": "haɪ",
    "goodbye": "ɡʊdˈbaɪ", "bye": "baɪ", "okay": "oʊˈkeɪ", "ok": "oʊˈkeɪ",
    # common nouns / adjectives
    "world": "wɜːɹld", "people": "ˈpiːpəl", "person": "ˈpɜːɹsən",
    "man": "mæn", "men": "mɛn", "woman": "ˈwʊmən", "women": "ˈwɪmɪn",
    "child": "tʃaɪld", "children": "ˈtʃɪldɹən", "life": "laɪf",
    "hand": "hænd", "part": "pɑːɹt", "place": "pleɪs", "case": "keɪs",
    "thing": "θɪŋ", "fact": "fækt", "group": "ɡɹuːp", "problem": "ˈpɹɑːbləm",
    "right": "ɹaɪt", "wrong": "ɹɔːŋ", "number": "ˈnʌmbɚ", "house": "haʊs",
    "home": "hoʊm", "water": "ˈwɔːtɚ", "room": "ɹuːm", "mother": "ˈmʌðɚ",
    "father": "ˈfɑːðɚ", "friend": "fɹɛnd", "family": "ˈfæməli",
    "area": "ˈɛɹiə", "money": "ˈmʌni", "story": "ˈstɔːɹi", "word": "wɜːɹd",
    "words": "wɜːɹdz", "book": "bʊk", "eye": "aɪ", "eyes": "aɪz",
    "head": "hɛd", "face": "feɪs", "voice": "vɔɪs", "sound": "saʊnd",
    "music": "ˈmjuːzɪk", "speech": "spiːtʃ", "language": "ˈlæŋɡwɪdʒ",
    "question": "ˈkwɛstʃən", "answer": "ˈænsɚ", "idea": "aɪˈdiə",
    "name": "neɪm", "school": "skuːl", "state": "steɪt",
    "country": "ˈkʌntɹi", "city": "ˈsɪti", "street": "stɹiːt",
    "road": "ɹoʊd", "car": "kɑːɹ", "door": "dɔːɹ", "light": "laɪt",
    "sun": "sʌn", "moon": "muːn", "star": "stɑːɹ", "sky": "skaɪ",
    "air": "ɛɹ", "fire": "faɪɚ", "earth": "ɜːɹθ", "sea": "siː",
    "tree": "tɹiː", "food": "fuːd", "dog": "dɔːɡ", "cat": "kæt",
    "bird": "bɜːɹd", "good": "ɡʊd", "bad": "bæd", "great": "ɡɹeɪt",
    "little": "ˈlɪtəl", "small": "smɔːl", "big": "bɪɡ", "large": "lɑːɹdʒ",
    "long": "lɔːŋ", "short": "ʃɔːɹt", "high": "haɪ", "low": "loʊ",
    "old": "oʊld", "young": "jʌŋ", "new": "nuː", "early": "ˈɜːɹli",
    "late": "leɪt", "important": "ɪmˈpɔːɹtənt", "different": "ˈdɪfɹənt",
    "next": "nɛkst", "last": "læst", "able": "ˈeɪbəl", "sure": "ʃʊɹ",
    "true": "tɹuː", "false": "fɔːls", "real": "ɹiːl", "whole": "hoʊl",
    "free": "fɹiː", "full": "fʊl", "easy": "ˈiːzi", "hard": "hɑːɹd",
    "strong": "stɹɔːŋ", "clear": "klɪɹ", "white": "waɪt", "black": "blæk",
    "red": "ɹɛd", "green": "ɡɹiːn", "blue": "bluː", "warm": "wɔːɹm",
    "cold": "koʊld", "hot": "hɑːt", "beautiful": "ˈbjuːtəfəl",
    "happy": "ˈhæpi", "nice": "naɪs", "fine": "faɪn", "once": "wʌns",
    "twice": "twaɪs", "mister": "ˈmɪstɚ", "missus": "ˈmɪsɪz",
    "doctor": "ˈdɑːktɚ", "now": "naʊ", "soon": "suːn", "yet": "jɛt",
    "ever": "ˈɛvɚ", "off": "ɔːf", "out": "aʊt", "up": "ʌp", "down": "daʊn",
}

# ordered grapheme → IPA rules (longest-match first)
_RULES = [
    ("tion", "ʃən"), ("sion", "ʒən"), ("ough", "ʌf"), ("augh", "ɔː"),
    ("eigh", "eɪ"), ("igh", "aɪ"), ("tch", "tʃ"), ("dge", "dʒ"),
    ("ch", "tʃ"), ("sh", "ʃ"), ("th", "θ"), ("ph", "f"), ("wh", "w"),
    ("ng", "ŋ"), ("nk", "ŋk"), ("ck", "k"), ("qu", "kw"), ("oo", "uː"), ("ee", "iː"),
    ("ea", "iː"), ("ou", "aʊ"), ("ow", "aʊ"), ("oi", "ɔɪ"), ("oy", "ɔɪ"),
    ("ai", "eɪ"), ("ay", "eɪ"), ("au", "ɔː"), ("aw", "ɔː"), ("ar", "ɑːɹ"),
    ("er", "əɹ"), ("ir", "ɜːɹ"), ("or", "ɔːɹ"), ("ur", "ɜːɹ"),
    ("a", "æ"), ("b", "b"), ("c", "k"), ("d", "d"), ("e", "ɛ"), ("f", "f"),
    ("g", "ɡ"), ("h", "h"), ("i", "ɪ"), ("j", "dʒ"), ("k", "k"), ("l", "l"),
    ("m", "m"), ("n", "n"), ("o", "ɑː"), ("p", "p"), ("r", "ɹ"), ("s", "s"),
    ("t", "t"), ("u", "ʌ"), ("v", "v"), ("w", "w"), ("x", "ks"), ("y", "j"),
    ("z", "z"),
]

# magic-e: the vowel before a stripped silent e says its name
_LONG_VOWEL = {"a": "eɪ", "e": "iː", "i": "aɪ", "o": "oʊ", "u": "uː"}

_VOICELESS = set("ptkfθsʃtʃ")


def _suffix_s(stem_ipa: str) -> str:
    """Voicing-sensitive plural/3sg: cats→s, dogs→z, buses→ɪz."""
    if not stem_ipa:
        return "z"
    last = stem_ipa[-1]
    if last in "szʃʒ" or stem_ipa.endswith(("tʃ", "dʒ")):
        return "ɪz"
    return "s" if last in _VOICELESS else "z"


def _suffix_ed(stem_ipa: str) -> str:
    """wanted→ɪd, walked→t, played→d."""
    if not stem_ipa:
        return "d"
    if stem_ipa[-1] in "td":
        return "ɪd"
    return "t" if stem_ipa[-1] in _VOICELESS else "d"


# --------------------------------------------------------------------- #
# CMUdict import: the canonical path to a ~130k-word lexicon. No dictionary
# data ships with the package, so the loader is pure code — point it at any
# cmudict.dict / cmudict-0.7b file and the fallback G2P becomes
# lexicon-backed at CMUdict scale.
# --------------------------------------------------------------------- #

# ARPABET (CMUdict phone set) → GenAm IPA, matching the conventions the
# built-in lexicon uses (ɹ for R, long marks on tense vowels, ɚ/ɜːɹ for
# rhotic schwa).
_ARPABET_IPA: Dict[str, str] = {
    "AA": "ɑː", "AE": "æ", "AH": "ʌ", "AO": "ɔː", "AW": "aʊ", "AY": "aɪ",
    "EH": "ɛ", "EY": "eɪ", "IH": "ɪ", "IY": "iː", "OW": "oʊ", "OY": "ɔɪ",
    "UH": "ʊ", "UW": "uː",
    "B": "b", "CH": "tʃ", "D": "d", "DH": "ð", "F": "f", "G": "ɡ",
    "HH": "h", "JH": "dʒ", "K": "k", "L": "l", "M": "m", "N": "n",
    "NG": "ŋ", "P": "p", "R": "ɹ", "S": "s", "SH": "ʃ", "T": "t",
    "TH": "θ", "V": "v", "W": "w", "Y": "j", "Z": "z", "ZH": "ʒ",
}


def arpabet_to_ipa(phones) -> str:
    """ARPABET phone list (with stress digits) → IPA string.

    Stress digits place ˈ/ˌ before the stressed vowel; unstressed AH0
    reduces to schwa and ER becomes ɜːɹ (stressed) / ɚ (unstressed)."""
    out = []
    for ph in phones:
        ph = ph.upper()
        digit = ""
        if ph and ph[-1].isdigit():
            ph, digit = ph[:-1], ph[-1]
        stress = {"1": "ˈ", "2": "ˌ"}.get(digit, "")
        if ph == "AH" and digit == "0":
            out.append("ə")
        elif ph == "ER":
            out.append(stress + ("ɜːɹ" if digit in ("1", "2") else "ɚ"))
        else:
            out.append(stress + _ARPABET_IPA[ph])
    return "".join(out)


def load_cmudict_lexicon(path) -> Dict[str, str]:
    """Parse a CMUdict-format file into an IPA lexicon dict.

    Accepts both cmudict.dict ('word  AH0 ...' lowercase) and cmudict-0.7b
    ('WORD  AH0 ...' with ';;;' comments, latin-1). Alternate pronunciations
    'WORD(2)' are skipped (first entry wins, CMUdict convention)."""
    lex: Dict[str, str] = {}
    with open(path, "rb") as f:
        for raw in f:
            line = raw.decode("latin-1").strip()
            if not line or line.startswith((";;;", "##")):
                continue
            parts = line.split()
            word = parts[0].lower()
            if "(" in word:  # alternate pronunciation
                continue
            word = word.replace("'", "")
            if not word.isalpha():
                continue
            try:
                lex[word] = arpabet_to_ipa(parts[1:])
            except KeyError:
                continue  # non-ARPABET garbage line
    return lex


def word_to_ipa(word: str, lexicon: Optional[Dict[str, str]] = None) -> str:
    lex = _LEXICON if lexicon is None else lexicon
    word = word.lower()
    # apostrophe-bearing lookup first: "we're" must not collapse onto the
    # past-tense "were" before the lexicon gets a chance
    if word in lex:
        return lex[word]
    word = word.replace("'", "")
    if word in lex:
        return lex[word]

    # suffix morphology: recurse on the stem so inflections of lexicon
    # words stay accurate ("worked" → wɜːɹk + t)
    if len(word) > 3:
        if word.endswith("ies"):
            stem = word_to_ipa(word[:-3] + "y", lex)
            return stem[:-1] + "iz" if stem.endswith("i") else stem + "iz"
        if word.endswith("es") and word[:-2] in lex:
            stem = lex[word[:-2]]
            return stem + _suffix_s(stem)
        if word.endswith("s") and not word.endswith("ss") and word[:-1] in lex:
            stem = lex[word[:-1]]
            return stem + _suffix_s(stem)
        if word.endswith("ed"):
            for stem_word in (word[:-2], word[:-2] + "e", word[:-3]):
                if stem_word in lex:
                    stem = lex[stem_word]
                    return stem + _suffix_ed(stem)
        if word.endswith("ing"):
            for stem_word in (word[:-3], word[:-3] + "e", word[:-4]):
                if stem_word in lex:
                    return lex[stem_word] + "ɪŋ"
        if word.endswith("ly") and word[:-2] in lex:
            return lex[word[:-2]] + "li"
        if word.endswith("ness") and word[:-4] in lex:
            return lex[word[:-4]] + "nəs"
        if word.endswith("ment") and word[:-4] in lex:
            return lex[word[:-4]] + "mənt"
        if word.endswith("ful") and word[:-3] in lex:
            return lex[word[:-3]] + "fəl"
        if word.endswith("er") and word[:-2] in lex:
            return lex[word[:-2]] + "ɚ"
        if word.endswith("est") and word[:-3] in lex:
            return lex[word[:-3]] + "əst"

    # word-final orthography patterns (unstressed-syllable endings English
    # spells consistently: -le→əl, -er→ɚ, -ow→oʊ, -en/-on→ən, -et→ət,
    # final -y→i); short words keep their monosyllabic readings (try→tɹaɪ,
    # how→haʊ, ten→tɛn)
    w = word
    final_ipa = ""
    vowels = "aeiou"
    if len(w) > 3 and w.endswith("le") and w[-3] not in vowels:
        w, final_ipa = w[:-2], "əl"
    elif len(w) > 4 and w.endswith("ey"):
        w, final_ipa = w[:-2], "i"
    elif len(w) > 3 and w.endswith("y") and w[-2] not in vowels + "y":
        w, final_ipa = w[:-1], "i"
    elif len(w) > 4 and w.endswith(("en", "on")) and w[-3] not in vowels:
        w, final_ipa = w[:-2], "ən"
    elif len(w) > 4 and w.endswith("et") and w[-3] not in vowels:
        w, final_ipa = w[:-2], "ət"
    elif len(w) > 3 and w.endswith("er"):
        w, final_ipa = w[:-2], "ɚ"
    elif len(w) > 4 and w.endswith("ow"):
        w, final_ipa = w[:-2], "oʊ"

    # magic-e: the trailing silent e lengthens the last single vowel
    magic_e = False
    if len(w) > 2 and w.endswith("e") and w[-2] not in "aeiou":
        w = w[:-1]
        magic_e = True
    out = []
    last_single_vowel = None  # (position in out, grapheme)
    i = 0
    while i < len(w):
        for pat, ipa in _RULES:
            if w.startswith(pat, i):
                if pat in _LONG_VOWEL:
                    last_single_vowel = (len(out), pat)
                out.append(ipa)
                i += len(pat)
                # doubled consonant letters are one sound (butter, rabbit)
                if len(pat) == 1 and pat not in vowels:
                    while i < len(w) and w[i] == pat:
                        i += 1
                break
        else:
            i += 1  # unknown char: drop
    if magic_e and last_single_vowel is not None:
        pos, grapheme = last_single_vowel
        out[pos] = _LONG_VOWEL[grapheme]  # "make" → meɪk
    return "".join(out) + final_ipa


class RuleBasedG2P(BasePhonemizer):
    """Approximate English G2P; drop-in for `ESpeak` when no binary exists.

    ``lexicon_path`` (or the ``NS2_CMUDICT`` environment variable) points at
    a CMUdict file; its ~130k entries are merged OVER the built-in lexicon
    and consulted before the LTS rules — lexicon-backed G2P at full scale
    from pure data."""

    def __init__(
        self,
        language: str = "en-us",
        punctuations: str = Punctuation.default_puncs(),
        keep_puncs: bool = True,
        lexicon_path: Optional[str] = None,
    ):
        super().__init__(language, punctuations=punctuations, keep_puncs=keep_puncs)
        import os

        path = lexicon_path or os.environ.get("NS2_CMUDICT")
        if path:
            self._lexicon = dict(_LEXICON)
            self._lexicon.update(load_cmudict_lexicon(path))
        else:
            self._lexicon = _LEXICON
        # non-English: route to the rule G2Ps in fallback_multi (es/fr —
        # the languages the upstream reference demos through the espeak
        # binary, its tokenizer.py:158-165)
        self._lang_prefix = (language or "en").split("-")[0].lower()

    @staticmethod
    def name() -> str:
        return "rule_based_en"

    @classmethod
    def is_available(cls) -> bool:
        return True

    @classmethod
    def version(cls) -> str:
        return "2.0"

    @staticmethod
    def supported_languages() -> dict:
        return {
            "en": "English", "en-us": "English (America)",
            "es": "Spanish (rule-based)", "fr-fr": "French (rule-based)",
        }

    def is_supported_language(self, language: str) -> bool:
        return True  # approximate output for any latin-script input

    def _phonemize(self, text: str, separator: str = "") -> str:
        if self._lang_prefix in ("es", "fr"):
            from naturalspeech2_tpu_torch.utils.phonemizers.fallback_multi import (
                phonemize_text,
            )

            return phonemize_text(text, self._lang_prefix, separator)
        words = re.findall(r"[A-Za-z']+", text)
        sep = separator or ""
        lex = self._lexicon
        return " ".join(
            sep.join(word_to_ipa(w, lex)) if sep else word_to_ipa(w, lex)
            for w in words
        )


def default_phonemizer(language: str = "en-us", **kwargs):
    """ESpeak when installed, rule-based fallback otherwise."""
    from naturalspeech2_tpu_torch.utils.phonemizers.espeak_wrapper import ESpeak

    if ESpeak.is_available():
        return ESpeak(language, **kwargs)
    return RuleBasedG2P(language, **kwargs)
