"""WordPiece tokenizer, implemented from scratch (no HF download needed).

A copy of ``anncur_tpu/models/tokenizer.py`` (importing that module would
load JAX through ``anncur_tpu/models/__init__.py``); tests hold the two
to identical ids.

Byte-identical with BERT's reference basic+wordpiece algorithm given the
same vocab file (lowercasing, accent stripping, punctuation splitting,
CJK spacing, greedy longest-match-first with '##' continuations). The
reference uses pytorch_transformers.BertTokenizer with do_lower_case=True
(models/biencoder.py:295-312); recall parity requires identical token ids
(SURVEY §7 'hard parts').

Tested for exact agreement against ``transformers.BertTokenizer``
constructed from the same local vocab (tests/test_tokenizer.py).
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Optional


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges treated as punctuation even when unicode disagrees
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF
        or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF
        or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F
        or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF
        or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    def __init__(self, do_lower_case: bool = True, never_split: Optional[Iterable[str]] = None):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split or ())

    def tokenize(self, text: str) -> List[str]:
        text = self._clean(text)
        text = self._space_cjk(text)
        tokens = text.strip().split() if text.strip() else []
        out: List[str] = []
        for tok in tokens:
            if tok in self.never_split:
                out.append(tok)
                continue
            if self.do_lower_case:
                tok = tok.lower()
                tok = self._strip_accents(tok)
            out.extend(self._split_punc(tok))
        return " ".join(out).split()

    @staticmethod
    def _clean(text: str) -> str:
        chars = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            chars.append(" " if _is_whitespace(ch) else ch)
        return "".join(chars)

    @staticmethod
    def _space_cjk(text: str) -> str:
        chars = []
        for ch in text:
            if _is_cjk(ord(ch)):
                chars.extend((" ", ch, " "))
            else:
                chars.append(ch)
        return "".join(chars)

    @staticmethod
    def _strip_accents(text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text) if unicodedata.category(ch) != "Mn"
        )

    @staticmethod
    def _split_punc(token: str) -> List[str]:
        out: List[List[str]] = []
        new_word = True
        for ch in token:
            if _is_punctuation(ch):
                out.append([ch])
                new_word = True
            else:
                if new_word:
                    out.append([])
                new_word = False
                out[-1].append(ch)
        return ["".join(seg) for seg in out if seg]


class WordPieceTokenizer:
    """BERT tokenizer: basic tokenization + greedy WordPiece."""

    SPECIAL_TOKENS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")

    def __init__(
        self,
        vocab: Dict[str, int],
        do_lower_case: bool = True,
        unk_token: str = "[UNK]",
        max_chars_per_word: int = 100,
        never_split: Optional[Iterable[str]] = None,
    ):
        self.vocab = dict(vocab)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word
        # special tokens are never split, even embedded mid-text
        # (HF added-token trie semantics; found by fuzzing vs HF)
        self.never_split = tuple(never_split) if never_split else self.SPECIAL_TOKENS
        self.basic = BasicTokenizer(do_lower_case, self.never_split)
        self.cls_token = "[CLS]"
        self.sep_token = "[SEP]"
        self.pad_token = "[PAD]"

    # ---------------- construction ------------------------------------ #

    @classmethod
    def from_vocab_file(cls, path: str, **kw) -> "WordPieceTokenizer":
        vocab: Dict[str, int] = {}
        with open(path, encoding="utf-8") as fin:
            for i, line in enumerate(fin):
                tok = line.rstrip("\n")
                if tok:
                    vocab[tok] = i
        return cls(vocab, **kw)

    def save_vocab(self, path: str) -> None:
        """Line index == token id. Ids with no token (a gapped vocab)
        are written as blank lines so a save/load round trip preserves
        EVERY id — writing tokens consecutively silently shifted all ids
        after a gap, corrupting encodings against checkpoints built with
        the original ids."""
        by_id = {i: t for t, i in self.vocab.items()}
        with open(path, "w", encoding="utf-8") as fout:
            for i in range(max(by_id) + 1 if by_id else 0):
                fout.write(by_id.get(i, "") + "\n")

    # ---------------- tokenize ----------------------------------------- #

    def wordpiece(self, token: str) -> List[str]:
        if len(token) > self.max_chars_per_word:
            return [self.unk_token]
        out: List[str] = []
        start = 0
        n = len(token)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = token[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return [self.unk_token]
            out.append(cur)
            start = end
        return out

    def _split_on_specials(self, text: str) -> List[str]:
        """Split text on literal special-token occurrences (even without
        surrounding whitespace), keeping the specials as segments."""
        segments = [text]
        for special in self.never_split:
            if special not in text:
                continue
            new_segments: List[str] = []
            for seg in segments:
                if seg in self.never_split:
                    new_segments.append(seg)
                    continue
                parts = seg.split(special)
                for i, part in enumerate(parts):
                    if i:
                        new_segments.append(special)
                    if part:
                        new_segments.append(part)
            segments = new_segments
        return segments

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for segment in self._split_on_specials(text):
            if segment in self.never_split:
                out.append(segment)
                continue
            for tok in self.basic.tokenize(segment):
                out.extend(self.wordpiece(tok))
        return out

    def convert_tokens_to_ids(self, tokens: List[str]) -> List[int]:
        unk = self.vocab[self.unk_token]
        return [self.vocab.get(t, unk) for t in tokens]

    def convert_ids_to_tokens(self, ids: List[int]) -> List[str]:
        return [self.ids_to_tokens.get(i, self.unk_token) for i in ids]

    def encode(self, text: str) -> List[int]:
        return self.convert_tokens_to_ids(self.tokenize(text))

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)


def make_realistic_vocab(n_words: int = 24000, seed: int = 0) -> Dict[str, int]:
    """A bert-base-uncased-SHAPED vocab (~30k entries) for tokenizer
    parity fuzzing when the real 30,522-token vocab is unobtainable
    (zero-egress environments; see PARITY.md).

    Mirrors the real file's structural layout: [PAD]=0, [unused0..98]=1-99,
    [UNK]=100, [CLS]=101, [SEP]=102, [MASK]=103, [unused99..992]=104-997,
    then single characters (ascii, latin-1 accents, greek, cyrillic, CJK),
    then whole words and ##-continuation pieces generated deterministically
    from English-like syllables. Exercises every WordPiece code path the
    real vocab does: multi-char greedy longest-match, continuation pieces,
    punctuation/CJK isolation, accent stripping, [unused*] never-split.
    """
    import random

    tokens = ["[PAD]"] + [f"[unused{i}]" for i in range(99)]
    tokens += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens += [f"[unused{i}]" for i in range(99, 993)]
    chars = list("!\"#$%&'()*+,-./0123456789:;<=>?@[\\]^_`abcdefghijklmnopqrstuvwxyz{|}~")
    chars += list("¡¢£¤¥¦§¨©ª«¬®¯°±²³´µ¶·¸¹º»¼½¾¿")
    chars += [chr(c) for c in range(0x00E0, 0x00FF)]  # accented latin
    chars += [chr(c) for c in range(0x03B1, 0x03C9)]  # greek
    chars += [chr(c) for c in range(0x0430, 0x0450)]  # cyrillic
    chars += [chr(c) for c in range(0x4E00, 0x4E80)]  # CJK
    tokens += chars
    tokens += ["##" + c for c in chars]
    rnd = random.Random(seed)
    onsets = ["b", "c", "d", "f", "g", "h", "j", "k", "l", "m", "n", "p", "r",
              "s", "t", "v", "w", "z", "ch", "sh", "th", "st", "tr", "pl", ""]
    nuclei = ["a", "e", "i", "o", "u", "ai", "ea", "ou", "io"]
    codas = ["", "n", "r", "s", "t", "l", "m", "ng", "st", "ck"]
    seen = set(tokens)
    while len(tokens) < 4000 + n_words:
        n_syll = rnd.randint(1, 3)
        w = "".join(
            rnd.choice(onsets) + rnd.choice(nuclei) + rnd.choice(codas)
            for _ in range(n_syll)
        )
        if not w:
            continue
        if rnd.random() < 0.35:
            w = "##" + w
        if w not in seen:
            seen.add(w)
            tokens.append(w)
    return {t: i for i, t in enumerate(tokens)}


def make_test_vocab(extra_words: Iterable[str] = ()) -> Dict[str, int]:
    """Tiny deterministic vocab for tests: specials + ascii chars + '##'
    continuations + caller-specified whole words."""
    tokens = ["[PAD]", "[unused0]", "[unused1]", "[unused2]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    tokens += list("abcdefghijklmnopqrstuvwxyz0123456789.,!?-'\"")
    tokens += ["##" + c for c in "abcdefghijklmnopqrstuvwxyz0123456789"]
    for w in extra_words:
        if w not in tokens:
            tokens.append(w)
    return {t: i for i, t in enumerate(tokens)}
