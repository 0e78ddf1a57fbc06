"""A numpy model of ``csrc/bitvector.cuh``'s column step (Myers 1999 in
Hyyro's 64-row words), shared by the models of kernels B5
(``tests/test_torch_fuzzy_kernel.py``) and B6
(``tests/test_torch_dovetail_kernel.py``)."""

import numpy as np

U64, ONE, ALL = np.uint64, np.uint64(1), ~np.uint64(0)


def column_step(eqs, pv, mv, hin, *, carry_between_words=True):
    """One column over a lane batch's words (lists of (lanes,) uint64, low
    rows first), as ``bitvector::column_step``: pv, mv in place; returns
    each word's horizontal +1 and -1 deltas before the shift."""
    phs, mhs = [], []
    carry, ph_in, mh_in = np.zeros_like(hin), hin, np.zeros_like(hin)
    for w in range(len(pv)):
        eq = eqs[w]
        xv = eq | mv[w]
        t = eq & pv[w]
        s1 = t + pv[w]
        s = s1 + (carry if carry_between_words else U64(0))
        carry = ((s1 < t) | (s < s1)).astype(U64)
        xh = (s ^ pv[w]) | eq
        ph = mv[w] | ~(xh | pv[w])
        mh = pv[w] & xh
        phs_, mhs_ = (ph << ONE) | ph_in, (mh << ONE) | mh_in
        ph_in, mh_in = ph >> U64(63), mh >> U64(63)
        pv[w] = mhs_ | ~(xv | phs_)
        mv[w] = phs_ & xv
        phs.append(ph)
        mhs.append(mh)
    return phs, mhs


def row_delta(plus, minus, r):
    """Each lane's delta at row r >= 1 (``bitvector::Row``); 0 at row 0."""
    if not plus:
        return np.zeros(r.shape, np.int64)
    rr = np.maximum(r - 1, 0)
    w, lanes, sh = rr // 64, np.arange(len(r)), (rr % 64).astype(U64)
    bit = lambda words: ((np.stack(words)[w, lanes] >> sh) & ONE).astype(np.int64)  # noqa: E731
    return np.where(r >= 1, bit(plus) - bit(minus), 0)
