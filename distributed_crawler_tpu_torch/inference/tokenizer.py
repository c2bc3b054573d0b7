"""Host-side tokenization feeding the device queue.

A copy of the reference's `HashingTokenizer`
(`distributed_crawler_tpu/inference/tokenizer.py`): dependency-free and
deterministic (FNV-1a over NFKC-lowercased word pieces).  Its ids must equal
the reference's for every text — the parity tests check that.  Loading a
real vocabulary (`from_pretrained_dir`) waits for a later slice.
"""

from __future__ import annotations

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
