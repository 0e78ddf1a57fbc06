"""Synthetic ONT TCR-amplicon read simulator.

The reference repo has no tests and no simulator (SURVEY §4); its behavioral
spec is empirical QC on real PromethION runs. This module is the rebuild's
test bed (SURVEY §7 M0): generate a toy reference library plus reads with
*known* per-molecule UMIs and a controllable error model, so every stage —
EE filtering, alignment, region split, UMI extraction, clustering, consensus,
counting — can be asserted against ground truth, up to bit-exact UMI counts.

Amplicon structure mirrors what the reference pipeline assumes
(ont_tcr_consensus/extract_umis.py:110-126: fwd UMI within
the first ~81 nt of the oriented read, rev UMI within the last ~76 nt;
configs/run_config.json:9-12):

    5'- left_flank . UMI_fwd . region_sequence . UMI_rev . right_flank -3'

Reads are emitted in + or - orientation with ONT-like errors
(sub/ins/del, qualities consistent with the error rate).
"""

from __future__ import annotations

import dataclasses

import numpy as np

_BASES = np.array(list("ACGT"))
_IUPAC_CHOICES = {
    "A": "A", "C": "C", "G": "G", "T": "T",
    "R": "AG", "Y": "CT", "S": "CG", "W": "AT", "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
}

# Short fixed flanks standing in for the sequencing adapters/primers that
# dorado trim leaves behind; lengths chosen so UMIs sit inside the default
# 81/76 nt softclip windows (run_config.json:9-10).
LEFT_FLANK = "CAAGCAGAAGACGGCATACGAGAT"
RIGHT_FLANK = "AATGATACGGCGACCACCGAGATC"

# Full UVP primers (adapter+GSP) for untrimmed-read simulation: the amplicon
# carries the forward primer at its 5' end and the reverse complement of the
# reverse primer at its 3' end, exactly what the trim stage must remove
# (dorado trim --primer-sequences analogue; reference primers/primers.fasta).
PRIMER_FWD = "CAAGCAGAAGACGGCATACGAGATGTATCGTGTAGAGACTGCGTAGG"
PRIMER_REV = "AATGATACGGCGACCACCGAGATCAGTGATCGAGTCAGTGCGAGTG"


def _rand_seq(rng: np.random.Generator, n: int) -> str:
    return "".join(_BASES[rng.integers(0, 4, size=n)])


def instantiate_iupac(rng: np.random.Generator, pattern: str) -> str:
    """Draw a concrete sequence from a degenerate IUPAC pattern."""
    return "".join(
        c if len(_IUPAC_CHOICES[c]) == 1 else _IUPAC_CHOICES[c][rng.integers(len(_IUPAC_CHOICES[c]))]
        for c in pattern.upper()
    )


def revcomp(seq: str) -> str:
    """Delegates to the pipeline's own encoding so semantics never diverge."""
    from ont_tcrconsensus_tpu_torch.ops import encode

    return encode.revcomp_str(seq)


def mutate(
    rng: np.random.Generator,
    seq: str,
    sub_rate: float,
    ins_rate: float,
    del_rate: float,
) -> tuple[str, str]:
    """Apply iid sub/ins/del errors; return (read, phred33 quality string).

    Quality is drawn around the Q implied by the total error rate, so the
    expected-error filter sees realistic values.
    """
    total = max(sub_rate + ins_rate + del_rate, 1e-6)
    q_mid = int(np.clip(-10.0 * np.log10(total), 5, 40))
    out: list[str] = []
    quals: list[int] = []
    for ch in seq:
        r = rng.random()
        if r < del_rate:
            continue
        if r < del_rate + ins_rate:
            out.append(str(_BASES[rng.integers(4)]))
            quals.append(max(2, q_mid - 6))
        if rng.random() < sub_rate:
            choices = [b for b in "ACGT" if b != ch]
            out.append(choices[rng.integers(3)])
            quals.append(max(2, q_mid - 4))
        else:
            out.append(ch)
            quals.append(int(np.clip(rng.normal(q_mid, 3), 2, 50)))
    qual = "".join(chr(33 + q) for q in quals)
    return "".join(out), qual


@dataclasses.dataclass(frozen=True)
class OntErrorModel:
    """Systematic (non-iid) ONT error structure.

    The iid :func:`mutate` model is the regime where majority voting is
    already near-optimal — which made the round-2 polisher eval circular
    (VERDICT r2 weak #3). Real ONT errors are structured; medaka exists to
    fix exactly that structure (ref medaka_polish.py:113-134). This model
    reproduces the three dominant modes reported for R10.4 chemistry:

    - **homopolymer-length-dependent indels**: a base inside a homopolymer
      run of length r deletes with probability ``del_rate * min(1 +
      hp_slope*(r-1), hp_cap)`` — runs shrink systematically, the classic
      ONT failure voting cannot fix (every subread shrinks the same run);
      insertions inside a run duplicate the run base.
    - **context-biased substitutions**: the sub rate at a position is
      multiplied by a per-(prev base, base) context factor
      (``motif_sub_boost``); substitutions are transitions (A<->G, C<->T)
      with probability ``transition_frac`` instead of uniform.
    - **strand asymmetry**: callers apply the model to the *sequenced*
      strand (:func:`simulate_library` mutates after orientation), so a
      boosted context on one strand is a different context on the other —
      '+' and '-' reads of one molecule carry different systematic errors.
    """

    sub_rate: float = 0.006
    ins_rate: float = 0.002
    del_rate: float = 0.004
    hp_slope: float = 1.0
    hp_cap: float = 10.0
    # context multipliers: (prev_base, base) -> sub-rate factor. Defaults
    # boost pyrimidine-after-purine calls, a reported ONT bias family.
    motif_sub_boost: tuple = (("GA", 3.0), ("CT", 2.5), ("TC", 2.0))
    transition_frac: float = 0.6

    def context_matrix(self) -> np.ndarray:
        m = np.ones((4, 4), np.float64)
        code = {"A": 0, "C": 1, "G": 2, "T": 3}
        for pair, f in self.motif_sub_boost:
            m[code[pair[0]], code[pair[1]]] = f
        return m


_TRANSITION = np.array([2, 3, 0, 1], np.int8)  # A<->G, C<->T
_CODE_OF = np.full(128, -1, np.int8)
for _i, _b in enumerate("ACGT"):
    _CODE_OF[ord(_b)] = _i


def _run_lengths(codes: np.ndarray) -> np.ndarray:
    """Length of the homopolymer run containing each position (vectorized)."""
    n = len(codes)
    if n == 0:
        return np.zeros(0, np.int32)
    boundary = np.empty(n, bool)
    boundary[0] = True
    boundary[1:] = codes[1:] != codes[:-1]
    run_id = np.cumsum(boundary) - 1
    counts = np.bincount(run_id)
    return counts[run_id].astype(np.int32)


def mutate_ont(
    rng: np.random.Generator, seq: str, model: OntErrorModel
) -> tuple[str, str]:
    """Apply the systematic ONT error model; returns (read, phred33 quals).

    Vectorized (no per-character Python loop): position-wise deletion /
    substitution / insertion draws with homopolymer- and context-dependent
    rates, then one splice pass.
    """
    codes = _CODE_OF[np.frombuffer(seq.encode("ascii"), np.uint8)].astype(np.int8)
    known = codes >= 0
    n = len(codes)
    if n == 0:
        return "", ""
    runs = _run_lengths(codes)
    hp_mult = np.minimum(1.0 + model.hp_slope * (runs - 1), model.hp_cap)

    del_p = np.where(known, model.del_rate * hp_mult, 0.0)
    ctx = model.context_matrix()
    prev = np.concatenate([[0], np.clip(codes[:-1], 0, 3)])
    sub_p = np.where(
        known, model.sub_rate * ctx[prev, np.clip(codes, 0, 3)], 0.0
    )
    ins_p = np.where(known, model.ins_rate * hp_mult, model.ins_rate)

    u = rng.random((3, n))
    deleted = u[0] < del_p
    substituted = ~deleted & (u[1] < sub_p)
    inserted = u[2] < ins_p  # one extra base BEFORE this position

    new_base = codes.copy()
    is_trans = rng.random(n) < model.transition_frac
    trans = _TRANSITION[np.clip(codes, 0, 3)]
    shift = rng.integers(1, 4, n).astype(np.int8)
    transv = (np.clip(codes, 0, 3) + shift) % 4
    transv = np.where(transv == trans, (transv + 1) % 4, transv).astype(np.int8)
    new_base = np.where(substituted & is_trans, trans, new_base)
    new_base = np.where(substituted & ~is_trans, transv, new_base)

    # inserted base: duplicate the run base inside homopolymers, random else
    ins_base = np.where(
        (runs > 1) & known, np.clip(codes, 0, 3), rng.integers(0, 4, n)
    ).astype(np.int8)

    total = max(model.sub_rate + model.ins_rate + model.del_rate, 1e-6)
    q_mid = int(np.clip(-10.0 * np.log10(total), 5, 40))
    base_q = np.clip(rng.normal(q_mid, 3, n), 2, 50).astype(np.int32)
    base_q = np.where(substituted, np.maximum(2, q_mid - 4), base_q)
    # low-ish quality on homopolymer tails, where the signal truly is flat
    base_q = np.where(runs >= 4, np.maximum(2, base_q - 6), base_q)

    out_codes: list[np.ndarray] = []
    out_quals: list[np.ndarray] = []
    keep = ~deleted
    # interleave insertions: build (2, n) stacks [ins?, base?] then mask
    stack_codes = np.stack([ins_base, new_base], axis=1).reshape(-1)
    stack_keep = np.stack([inserted, keep], axis=1).reshape(-1)
    stack_quals = np.stack(
        [np.full(n, max(2, q_mid - 6), np.int32), base_q], axis=1
    ).reshape(-1)
    out_codes = stack_codes[stack_keep]
    out_quals = stack_quals[stack_keep]
    read = np.frombuffer(b"ACGT", np.uint8)[np.clip(out_codes, 0, 3)].tobytes().decode()
    qual = "".join(chr(33 + int(q)) for q in out_quals)
    return read, qual


@dataclasses.dataclass
class Molecule:
    """Ground truth for one unique molecule (one expected consensus)."""

    region: str
    umi_fwd: str   # concrete fwd UMI (as in + orientation)
    umi_rev: str   # concrete rev UMI (as in + orientation)
    num_reads: int

    @property
    def combined_umi(self) -> str:
        return self.umi_fwd + self.umi_rev


@dataclasses.dataclass
class SimulatedLibrary:
    reference: dict[str, str]        # region name -> sequence
    molecules: list[Molecule]
    reads: list[tuple[str, str, str]]  # (header, sequence, qual)

    @property
    def true_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for m in self.molecules:
            counts[m.region] = counts.get(m.region, 0) + 1
        return counts


def make_reference(
    rng: np.random.Generator,
    num_regions: int = 8,
    region_len: tuple[int, int] = (1500, 2200),
    num_similar_pairs: int = 0,
    similar_divergence: float = 0.01,
    num_negative_controls: int = 0,
) -> dict[str, str]:
    """Toy TCR reference library.

    ``num_similar_pairs`` appends near-duplicate regions (>= 99% identical by
    default) to exercise the self-homology region clustering
    (region_split.py:61-216). Negative controls get the reference's reserved
    suffixes (region_split.py:302-309) and receive no molecules.
    """
    ref: dict[str, str] = {}
    for i in range(num_regions):
        n = int(rng.integers(region_len[0], region_len[1] + 1))
        ref[f"TCR{i:04d}"] = _rand_seq(rng, n)
    names = list(ref)
    for j in range(num_similar_pairs):
        src = names[j % len(names)]
        seq = list(ref[src])
        n_mut = max(1, int(len(seq) * similar_divergence))
        for pos in rng.choice(len(seq), size=n_mut, replace=False):
            choices = [b for b in "ACGT" if b != seq[pos]]
            seq[pos] = choices[rng.integers(3)]
        ref[f"{src}_sim{j}"] = "".join(seq)
    for k in range(num_negative_controls):
        n = int(rng.integers(region_len[0], region_len[1] + 1))
        ref[f"NC{k:03d}_full_n"] = _rand_seq(rng, n)
    return ref


def simulate_library(
    seed: int = 0,
    num_regions: int = 8,
    molecules_per_region: tuple[int, int] = (2, 6),
    reads_per_molecule: tuple[int, int] = (4, 12),
    sub_rate: float = 0.01,
    ins_rate: float = 0.005,
    del_rate: float = 0.005,
    umi_fwd_pattern: str = "TTTVVTTVVVVTTVVVVTTVVVVTTVVVVTTT",
    umi_rev_pattern: str = "AAABBBBAABBBBAABBBBAABBBBAABBAAA",
    reference: dict[str, str] | None = None,
    with_adapters: bool = False,
    error_model: OntErrorModel | None = None,
    **reference_kwargs,
) -> SimulatedLibrary:
    """Generate a full library with ground truth.

    Reads are shuffled and emitted in random +/- orientation; headers carry
    ``mol=<i>`` ground-truth tags (ignored by the pipeline, used by tests).

    ``with_adapters=True`` emits UNTRIMMED reads: the full UVP forward
    primer at the 5' end and revcomp of the reverse primer at the 3' end
    (what the basecaller hands to ``dorado trim``) — requires the pipeline's
    primer-trim stage. The default emits pre-trimmed reads with the short
    leftover flanks.

    ``error_model`` switches from iid errors (``sub/ins/del_rate``) to the
    systematic :class:`OntErrorModel`; errors are then applied to the
    SEQUENCED strand (after orientation), so strand asymmetry is real.
    """
    rng = np.random.default_rng(seed)
    ref = reference if reference is not None else make_reference(
        rng, num_regions=num_regions, **reference_kwargs
    )
    molecules: list[Molecule] = []
    reads: list[tuple[str, str, str]] = []
    countable = [n for n in ref if not n.endswith(("_v_n", "cdr3j_n", "full_n"))]
    for region in countable:
        n_mol = int(rng.integers(molecules_per_region[0], molecules_per_region[1] + 1))
        for _ in range(n_mol):
            mol = Molecule(
                region=region,
                umi_fwd=instantiate_iupac(rng, umi_fwd_pattern),
                umi_rev=instantiate_iupac(rng, umi_rev_pattern),
                num_reads=int(rng.integers(reads_per_molecule[0], reads_per_molecule[1] + 1)),
            )
            molecules.append(mol)
    left = PRIMER_FWD if with_adapters else LEFT_FLANK
    right = revcomp(PRIMER_REV) if with_adapters else RIGHT_FLANK
    for mi, mol in enumerate(molecules):
        template = (
            left + mol.umi_fwd + ref[mol.region] + mol.umi_rev + right
        )
        template_rc = revcomp(template)
        for ri in range(mol.num_reads):
            orient = "-" if rng.random() < 0.5 else "+"
            if error_model is not None:
                # mutate the sequenced strand: systematic contexts differ
                # between orientations, like a real flow cell
                seq, qual = mutate_ont(
                    rng, template_rc if orient == "-" else template, error_model
                )
            else:
                seq, qual = mutate(rng, template, sub_rate, ins_rate, del_rate)
                if orient == "-":
                    seq, qual = revcomp(seq), qual[::-1]
            reads.append((f"read_m{mi}_r{ri} mol={mi} orient={orient}", seq, qual))
    order = rng.permutation(len(reads))
    reads = [reads[i] for i in order]
    return SimulatedLibrary(reference=ref, molecules=molecules, reads=reads)
