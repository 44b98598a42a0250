"""DNA sequence encoding as packed NumPy arrays.

The reference keeps sequences as C++ strings and re-derives case / N-ness with
``isupper``/``toupper`` everywhere (``src/common.h:58-93``).  This
design instead encodes a sequence ONCE into two parallel ``uint8`` arrays:

* ``code``  — 2-bit base code (A=0, C=1, G=2, T=3; anything else 0), the same
  lookup as ``dna_hash_lookup`` (``common.h:58-69``).
* ``cls``   — per-base class: 0 = uppercase ACGT, 1 = lowercase acgt,
  2 = N / non-ACGT, mirroring the three-state ``Hash::Status``
  (``hash.h:21-25``).

All downstream device kernels consume these arrays; strings only appear at the
I/O boundary.
"""

from __future__ import annotations

import numpy as np

# Class codes.
CLS_UPPER = 0
CLS_LOWER = 1
CLS_N = 2

# Alignment alphabet (``dna_align_lookup``, common.h:70): ACGT -> 0..3, else 4
# (wildcard / N; scores 0 against everything in the DP kernel).
WILDCARD = 4

_CODE_LUT = np.zeros(256, dtype=np.uint8)
# Class semantics follow the reference exactly: only 'N'/'n' count as N
# (``toupper(s[i]) == 'N'``, hash.cc:65); any other character is classed by
# ``isupper`` (hash.cc:67) — so IUPAC codes like 'R' are "uppercase" with
# base code 0, and punctuation is "lowercase".
_CLS_LUT = np.full(256, CLS_LOWER, dtype=np.uint8)
_CLS_LUT[ord("A"):ord("Z") + 1] = CLS_UPPER
_CLS_LUT[ord("N")] = CLS_N
_CLS_LUT[ord("n")] = CLS_N
_ALIGN_LUT = np.full(256, WILDCARD, dtype=np.uint8)
_RC_LUT = np.full(256, ord("N"), dtype=np.uint8)
for _i, (_u, _l) in enumerate(zip(b"ACGT", b"acgt")):
    _CODE_LUT[_u] = _CODE_LUT[_l] = _i
    _ALIGN_LUT[_u] = _ALIGN_LUT[_l] = _i
for _a, _b in zip(b"ACGTacgt", b"TGCAtgca"):
    _RC_LUT[_a] = _b


class PackedSeq:
    """A named, encoded DNA sequence (equivalent of ``Sequence``, hash.h:42-48).

    ``is_rc`` marks that the underlying arrays already hold the reverse
    complement (the reference revcomps eagerly at construction,
    ``hash.cc:104-109``).
    """

    __slots__ = ("name", "code", "cls", "is_rc", "_seq_bytes")

    def __init__(self, name: str, seq: "str | bytes | np.ndarray",
                 is_rc: bool = False, _encoded: tuple | None = None):
        self.name = name
        self.is_rc = is_rc
        if _encoded is not None:
            self.code, self.cls, self._seq_bytes = _encoded
            return
        if isinstance(seq, str):
            raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
        elif isinstance(seq, (bytes, bytearray)):
            raw = np.frombuffer(bytes(seq), dtype=np.uint8)
        else:
            raw = np.asarray(seq, dtype=np.uint8)
        if is_rc:
            raw = _RC_LUT[raw[::-1]]
        self._seq_bytes = raw
        self.code = _CODE_LUT[raw]
        self.cls = _CLS_LUT[raw]

    def __len__(self) -> int:
        return int(self.code.shape[0])

    @property
    def seq(self) -> str:
        return self._seq_bytes.tobytes().decode("ascii")

    def sub(self, start: int, end: int) -> str:
        return self._seq_bytes[start:end].tobytes().decode("ascii")

    def align_codes(self, start: int = 0, end: int | None = None) -> np.ndarray:
        """5-letter alignment alphabet codes (ACGT->0..3, else 4)."""
        raw = self._seq_bytes[start:end]
        return _ALIGN_LUT[raw]


def encode(seq: str) -> tuple[np.ndarray, np.ndarray]:
    """Encode a string into (code, cls) arrays."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _CODE_LUT[raw], _CLS_LUT[raw]


def encode_align(seq: str) -> np.ndarray:
    """Encode into the 5-letter alignment alphabet (wildcard=4)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _ALIGN_LUT[raw]


def revcomp(seq: str) -> str:
    """Reverse complement, preserving case (``util.cc:43-48``)."""
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _RC_LUT[raw[::-1]].tobytes().decode("ascii")


def uppercase_mask(seq: str) -> np.ndarray:
    raw = np.frombuffer(seq.encode("ascii"), dtype=np.uint8)
    return _CLS_LUT[raw] == CLS_UPPER
