"""Host-side tokenization feeding the device queue.

A copy of the reference's `HashingTokenizer`
(`distributed_crawler_tpu/inference/tokenizer.py`): dependency-free and
deterministic (FNV-1a over NFKC-lowercased word pieces).  Its ids must equal
the reference's for every text — the parity tests check that.
`from_pretrained_dir` loads a checkpoint's real vocabulary, as the
reference's does: ``tokenizer.json`` through the `tokenizers` runtime,
otherwise `transformers.AutoTokenizer`, both imported only when called.
"""

from __future__ import annotations

import os
import re
import unicodedata
from itertools import chain
from typing import List, Protocol, Sequence

PAD_ID = 0
CLS_ID = 1
SEP_ID = 2
UNK_ID = 3
_RESERVED = 4

_WORD_RE = re.compile(r"\w+|[^\w\s]", re.UNICODE)

# Files an HF tokenizer is built from, besides ``tokenizer.json``.  Without
# one, newer `transformers` releases build an EMPTY tokenizer from
# ``config.json``'s model type instead of raising.
_TOKENIZER_FILES = ("tokenizer_config.json", "vocab.txt", "vocab.json",
                    "sentencepiece.bpe.model", "spiece.model",
                    "tokenizer.model")


class Tokenizer(Protocol):
    vocab_size: int

    def encode(self, text: str) -> List[int]: ...

    def encode_batch(self, texts: Sequence[str]) -> List[List[int]]: ...


def _fnv1a(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


class HashingTokenizer:
    """Deterministic hashing tokenizer: NFKC-lowercase words + sub-word
    fallback for long tokens, mapped into [RESERVED, vocab) by FNV-1a.

    Whitespace tokens are memoized (bounded) as tuples of ids; per-token
    regex splitting equals whole-text splitting because neither ``\\w+`` nor
    ``[^\\w\\s]`` can match across whitespace.
    """

    _CACHE_MAX = 1 << 20

    def __init__(self, vocab_size: int, max_word_len: int = 12):
        if vocab_size <= _RESERVED:
            raise ValueError(f"vocab_size must exceed {_RESERVED}")
        self.vocab_size = vocab_size
        self.max_word_len = max_word_len
        self._memo: dict = {}

    def _fnv_id(self, piece: str) -> int:
        return _RESERVED + _fnv1a(piece.encode("utf-8")) % \
            (self.vocab_size - _RESERVED)

    def _hash_token(self, token: str) -> tuple:
        """Regex-split one whitespace token into words and punctuation,
        hash each (long words split into fixed-width pieces), and memoize
        the id tuple unless the token is much longer than a word."""
        w = self.max_word_len
        ids = []
        for piece in _WORD_RE.findall(token):
            if len(piece) <= w:
                ids.append(self._fnv_id(piece))
            else:
                ids.extend(self._fnv_id(piece[i:i + w])
                           for i in range(0, len(piece), w))
        out = tuple(ids)
        if len(token) <= 4 * w:
            memo = self._memo
            if len(memo) >= self._CACHE_MAX:
                memo.clear()
            memo[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        text = unicodedata.normalize("NFKC", text or "").lower()
        toks = text.split()
        memo_get = self._memo.get
        vals = list(map(memo_get, toks))
        if None in vals:
            for i, v in enumerate(vals):
                if v is None:
                    # Re-probe: an earlier miss in this text may have just
                    # memoized the same token.
                    hit = memo_get(toks[i])
                    vals[i] = hit if hit is not None \
                        else self._hash_token(toks[i])
        return [CLS_ID, *chain.from_iterable(vals), SEP_ID]

    def encode_batch(self, texts: Sequence[str]) -> List[List[int]]:
        return [self.encode(t) for t in texts]


def from_pretrained_dir(path: str):
    """Load a real tokenizer from a local directory (no network).

    Prefers a bare ``tokenizer.json`` via the `tokenizers` runtime (XLM-R/E5
    fast tokenizers, no sentencepiece); falls back to
    `transformers.AutoTokenizer`, which needs one of the tokenizer's own
    files in the directory (unlike the reference, which also asks it for
    a directory that has none).  Callers fall back to
    :class:`HashingTokenizer` when both raise."""
    tj = os.path.join(path, "tokenizer.json")
    if os.path.exists(tj):
        from tokenizers import Tokenizer as RustTokenizer

        tok = RustTokenizer.from_file(tj)

        class _FastWrapper:
            vocab_size = int(tok.get_vocab_size())

            @staticmethod
            def encode(text: str) -> List[int]:
                return tok.encode(text).ids

            @staticmethod
            def encode_batch(texts: Sequence[str]) -> List[List[int]]:
                return [e.ids for e in tok.encode_batch(list(texts))]

            @staticmethod
            def decode(ids: Sequence[int]) -> str:
                return tok.decode(list(ids))

        return _FastWrapper()

    if not any(os.path.exists(os.path.join(path, f))
               for f in _TOKENIZER_FILES):
        raise FileNotFoundError(f"no tokenizer files in {path}")
    from transformers import AutoTokenizer

    hf_tok = AutoTokenizer.from_pretrained(path, local_files_only=True)

    class _HFWrapper:
        vocab_size = int(hf_tok.vocab_size)

        @staticmethod
        def encode(text: str) -> List[int]:
            return hf_tok.encode(text, truncation=False)

        @staticmethod
        def encode_batch(texts: Sequence[str]) -> List[List[int]]:
            return [hf_tok.encode(t, truncation=False) for t in texts]

        @staticmethod
        def decode(ids: Sequence[int]) -> str:
            return hf_tok.decode(list(ids), skip_special_tokens=True)

    return _HFWrapper()
