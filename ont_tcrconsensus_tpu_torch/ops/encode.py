"""Base encoding for the device kernels (a copy of the JAX package's
``ops/encode.py``; the port imports nothing of that package).

Two representations:

1. **Dense codes** (uint8): A=0, C=1, G=2, T=3, N/unknown=4, PAD=5.
   Used for reads/references on the device; PAD never matches anything,
   N matches nothing under exact comparison (kernels that need IUPAC
   semantics convert codes to masks with :func:`codes_to_masks`).

2. **IUPAC 4-bit masks** (uint8): A=1, C=2, G=4, T=8, degenerate codes are
   ORs (e.g. V = A|C|G = 7, B = C|G|T = 14, N = 15), PAD=0.
   Two masked bases "match" iff ``mask_a & mask_b != 0``. This reproduces the
   60-pair IUPAC equality table the reference feeds edlib
   (ont_tcr_consensus/extract_umis.py:26-87) as a single AND.

All encoders are host-side numpy (they feed padded batches to the device);
mask comparison happens inside jitted kernels.
"""

from __future__ import annotations

import numpy as np

A, C, G, T, N_CODE, PAD_CODE = 0, 1, 2, 3, 4, 5

_IUPAC_MASK = {
    "A": 1, "C": 2, "G": 4, "T": 8, "U": 8,
    "R": 1 | 4, "Y": 2 | 8, "S": 2 | 4, "W": 1 | 8, "K": 4 | 8, "M": 1 | 2,
    "B": 2 | 4 | 8, "D": 1 | 4 | 8, "H": 1 | 2 | 8, "V": 1 | 2 | 4,
    "N": 15,
}

_CODE_LUT = np.full(256, N_CODE, dtype=np.uint8)
for _b, _c in (("A", A), ("C", C), ("G", G), ("T", T), ("U", T)):
    _CODE_LUT[ord(_b)] = _c
    _CODE_LUT[ord(_b.lower())] = _c

_MASK_LUT = np.zeros(256, dtype=np.uint8)
for _b, _m in _IUPAC_MASK.items():
    _MASK_LUT[ord(_b)] = _m
    _MASK_LUT[ord(_b.lower())] = _m

# dense code -> 4-bit mask (PAD -> 0 so padding never matches)
CODE_TO_MASK = np.array([1, 2, 4, 8, 15, 0], dtype=np.uint8)

# dense code -> complement code (A<->T, C<->G); N and PAD map to themselves
COMPLEMENT = np.array([T, G, C, A, N_CODE, PAD_CODE], dtype=np.uint8)

_DECODE = np.array(list("ACGTN-"), dtype="U1")
_DECODE_ASCII = np.frombuffer(b"ACGTN-", dtype=np.uint8)


def encode_seq(seq: str) -> np.ndarray:
    """String -> dense uint8 codes."""
    return _CODE_LUT[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def encode_mask(seq: str) -> np.ndarray:
    """String (may contain IUPAC degenerate bases) -> 4-bit masks."""
    return _MASK_LUT[np.frombuffer(seq.encode("ascii"), dtype=np.uint8)]


def decode_seq(codes: np.ndarray, length: int | None = None) -> str:
    """Dense codes -> string (PAD rendered as '-' then stripped via length)."""
    if length is not None:
        codes = codes[:length]
    return "".join(_DECODE[np.asarray(codes, dtype=np.int64)])


def decode_batch(codes: np.ndarray, lengths: np.ndarray) -> list[str]:
    """(B, W) dense codes + (B,) lengths -> list of strings.

    One vectorized LUT pass + per-row ``tobytes().decode`` — ~50x faster than
    per-character joins, which matters on the artifact-write path.
    """
    ascii_rows = _DECODE_ASCII[np.ascontiguousarray(codes)]
    lens = np.asarray(lengths)
    return [
        ascii_rows[i, : lens[i]].tobytes().decode("ascii")
        for i in range(ascii_rows.shape[0])
    ]


def decode_phred_batch(quals: np.ndarray, lengths: np.ndarray) -> list[str]:
    """(B, W) uint8 Phred batch + lengths -> Phred-33 quality strings."""
    q = np.ascontiguousarray(np.asarray(quals, dtype=np.uint8) + 33)
    lens = np.asarray(lengths)
    return [q[i, : lens[i]].tobytes().decode("ascii") for i in range(q.shape[0])]


def revcomp_codes(codes: np.ndarray, length: int | None = None) -> np.ndarray:
    """Reverse-complement of a dense-code array (host side).

    With ``length`` given, only the first ``length`` entries are the sequence;
    the result keeps padding at the tail.
    """
    if length is None:
        return COMPLEMENT[codes[::-1]]
    out = np.full_like(codes, PAD_CODE)
    out[:length] = COMPLEMENT[codes[:length][::-1]]
    return out


def revcomp_str(seq: str) -> str:
    return decode_seq(revcomp_codes(encode_seq(seq)))


def pad_batch(
    seqs: list[np.ndarray],
    pad_to: int | None = None,
    pad_value: int = PAD_CODE,
    multiple: int = 128,
) -> tuple[np.ndarray, np.ndarray]:
    """Stack variable-length code arrays into a padded (B, L) batch + lengths.

    L is rounded up to ``multiple`` (TPU lane width) for layout friendliness.
    Raises if a sequence exceeds the padded width — callers bucket by length
    and must pick a sufficient ``pad_to``.
    """
    lengths = np.array([len(s) for s in seqs], dtype=np.int32)
    max_len = int(pad_to if pad_to is not None else (lengths.max() if len(seqs) else 0))
    if multiple > 1:
        max_len = ((max_len + multiple - 1) // multiple) * multiple
    max_len = max(max_len, multiple)
    if len(seqs) and lengths.max() > max_len:
        raise ValueError(
            f"sequence of length {int(lengths.max())} exceeds padded width {max_len}"
        )
    out = np.full((len(seqs), max_len), pad_value, dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i, : len(s)] = s
    return out, lengths


def encode_batch(
    seqs: list[str], pad_to: int | None = None, multiple: int = 128
) -> tuple[np.ndarray, np.ndarray]:
    """List of strings -> (padded dense-code batch, lengths)."""
    return pad_batch([encode_seq(s) for s in seqs], pad_to=pad_to, multiple=multiple)


def encode_mask_batch(
    seqs: list[str], pad_to: int | None = None, multiple: int = 128
) -> tuple[np.ndarray, np.ndarray]:
    """List of (possibly degenerate) strings -> (padded mask batch, lengths)."""
    return pad_batch(
        [encode_mask(s) for s in seqs], pad_to=pad_to, pad_value=0, multiple=multiple
    )


def phred_batch(quals: list[str], pad_to: int | None = None, multiple: int = 128):
    """List of Phred-33 quality strings -> (padded uint8 Q batch, lengths).

    Padding gets Q=93 (error prob ~5e-10) so padded tails contribute nothing
    to expected-error sums.
    """
    arrs = []
    for q in quals:
        raw = np.frombuffer(q.encode("ascii"), dtype=np.uint8)
        if raw.size and raw.min() < 33:
            raise ValueError("quality string contains characters below Phred-33 '!'")
        arrs.append(raw - 33)
    return pad_batch(arrs, pad_to=pad_to, pad_value=93, multiple=multiple)
