"""The benchmark's library generator: a frozen copy of the port's read
simulator (``io/simulator.py``: the reference panel, IUPAC UMIs, the
systematic ONT error model, adapters) and of the lane-scale twin's
molecule builder (``scripts/torch_lane_scale_proof.py``), in NumPy only.

A traffic file (``tcrbench/traffic/<name>.json``) holds the parameters;
:func:`generate` turns them and a seed into a :class:`Library` whose reads
carry their truth (region, molecule, orientation). With the deep-lane
parameters and seed 33 it gives the lane ``chip_smoke.py`` has timed,
read for read. Per-read quality strings are built in one NumPy call
instead of a Python loop: the same characters, a fraction of the time.
"""

from __future__ import annotations

import dataclasses
import gzip
import os

import numpy as np

_BASES = np.array(list("ACGT"))
_IUPAC_CHOICES = {
    "A": "A", "C": "C", "G": "G", "T": "T",
    "R": "AG", "Y": "CT", "S": "CG", "W": "AT", "K": "GT", "M": "AC",
    "B": "CGT", "D": "AGT", "H": "ACT", "V": "ACG", "N": "ACGT",
}
LEFT_FLANK = "CAAGCAGAAGACGGCATACGAGAT"
RIGHT_FLANK = "AATGATACGGCGACCACCGAGATC"
PRIMER_FWD = "CAAGCAGAAGACGGCATACGAGATGTATCGTGTAGAGACTGCGTAGG"
PRIMER_REV = "AATGATACGGCGACCACCGAGATCAGTGATCGAGTCAGTGCGAGTG"
NEGATIVE_CONTROL_SUFFIXES = ("_v_n", "cdr3j_n", "full_n")
_COMPLEMENT = str.maketrans("ACGTNacgtn", "TGCANtgcan")


def revcomp(seq: str) -> str:
    return seq.translate(_COMPLEMENT)[::-1]


def _rand_seq(rng: np.random.Generator, n: int) -> str:
    return "".join(_BASES[rng.integers(0, 4, size=n)])


def instantiate_iupac(rng: np.random.Generator, pattern: str) -> str:
    return "".join(
        c if len(_IUPAC_CHOICES[c]) == 1 else _IUPAC_CHOICES[c][rng.integers(len(_IUPAC_CHOICES[c]))]
        for c in pattern.upper()
    )


@dataclasses.dataclass(frozen=True)
class OntErrorModel:
    """Homopolymer-length-dependent indels, context-biased substitutions
    (transitions with probability ``transition_frac``), applied to the
    sequenced strand."""

    sub_rate: float = 0.006
    ins_rate: float = 0.002
    del_rate: float = 0.004
    hp_slope: float = 1.0
    hp_cap: float = 10.0
    motif_sub_boost: tuple = (("GA", 3.0), ("CT", 2.5), ("TC", 2.0))
    transition_frac: float = 0.6

    def context_matrix(self) -> np.ndarray:
        m = np.ones((4, 4), np.float64)
        code = {"A": 0, "C": 1, "G": 2, "T": 3}
        for pair, f in self.motif_sub_boost:
            m[code[pair[0]], code[pair[1]]] = f
        return m


_TRANSITION = np.array([2, 3, 0, 1], np.int8)
_CODE_OF = np.full(128, -1, np.int8)
for _i, _b in enumerate("ACGT"):
    _CODE_OF[ord(_b)] = _i


def _run_lengths(codes: np.ndarray) -> np.ndarray:
    n = len(codes)
    if n == 0:
        return np.zeros(0, np.int32)
    boundary = np.empty(n, bool)
    boundary[0] = True
    boundary[1:] = codes[1:] != codes[:-1]
    run_id = np.cumsum(boundary) - 1
    return np.bincount(run_id)[run_id].astype(np.int32)


def mutate_ont(rng: np.random.Generator, seq: str, model: OntErrorModel) -> tuple[str, str]:
    """The error model on one template: (read, phred+33 qualities). Draws
    from ``rng`` in the simulator's order."""
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
    sub_p = np.where(known, model.sub_rate * ctx[prev, np.clip(codes, 0, 3)], 0.0)
    ins_p = np.where(known, model.ins_rate * hp_mult, model.ins_rate)

    u = rng.random((3, n))
    deleted = u[0] < del_p
    substituted = ~deleted & (u[1] < sub_p)
    inserted = u[2] < ins_p
    new_base = codes.copy()
    is_trans = rng.random(n) < model.transition_frac
    trans = _TRANSITION[np.clip(codes, 0, 3)]
    shift = rng.integers(1, 4, n).astype(np.int8)
    transv = (np.clip(codes, 0, 3) + shift) % 4
    transv = np.where(transv == trans, (transv + 1) % 4, transv).astype(np.int8)
    new_base = np.where(substituted & is_trans, trans, new_base)
    new_base = np.where(substituted & ~is_trans, transv, new_base)
    ins_base = np.where(
        (runs > 1) & known, np.clip(codes, 0, 3), rng.integers(0, 4, n)
    ).astype(np.int8)

    total = max(model.sub_rate + model.ins_rate + model.del_rate, 1e-6)
    q_mid = int(np.clip(-10.0 * np.log10(total), 5, 40))
    base_q = np.clip(rng.normal(q_mid, 3, n), 2, 50).astype(np.int32)
    base_q = np.where(substituted, np.maximum(2, q_mid - 4), base_q)
    base_q = np.where(runs >= 4, np.maximum(2, base_q - 6), base_q)

    keep = ~deleted
    stack_codes = np.stack([ins_base, new_base], axis=1).reshape(-1)
    stack_keep = np.stack([inserted, keep], axis=1).reshape(-1)
    stack_quals = np.stack([np.full(n, max(2, q_mid - 6), np.int32), base_q], axis=1).reshape(-1)
    out_codes = stack_codes[stack_keep]
    out_quals = stack_quals[stack_keep]
    read = np.frombuffer(b"ACGT", np.uint8)[np.clip(out_codes, 0, 3)].tobytes().decode()
    qual = (out_quals + 33).astype(np.uint8).tobytes().decode("ascii")
    return read, qual


@dataclasses.dataclass
class Molecule:
    region: str
    umi_fwd: str
    umi_rev: str
    num_reads: int
    # reads past ``num_reads``, one (truncated length, Phred shift) each:
    # a length > 0 cuts the read to that many bases from its 5' end, a
    # shift lowers every base's quality by that many Phred points
    extras: tuple = ()

    def template(self, reference: dict[str, str], with_adapters: bool) -> str:
        """The molecule's amplicon in + orientation, adapters included."""
        left = PRIMER_FWD if with_adapters else LEFT_FLANK
        right = revcomp(PRIMER_REV) if with_adapters else RIGHT_FLANK
        return left + self.umi_fwd + reference[self.region] + self.umi_rev + right


@dataclasses.dataclass
class Library:
    """A generated library and its truth: each read's molecule and
    orientation (``read_mol``, ``read_rev``), in read order."""

    reference: dict[str, str]
    molecules: list[Molecule]
    reads: list[tuple[str, str, str]]   # (header, sequence, phred+33)
    read_mol: np.ndarray                # (n_reads,) molecule index
    read_rev: np.ndarray                # (n_reads,) sequenced as the - strand
    read_extra: np.ndarray | None = None  # (n_reads,) one of a molecule's extras

    @property
    def true_counts(self) -> dict[str, int]:
        counts: dict[str, int] = {}
        for m in self.molecules:
            counts[m.region] = counts.get(m.region, 0) + 1
        return counts

    def name(self, i: int) -> str:
        return self.reads[i][0].split(" ", 1)[0]


def make_reference(rng: np.random.Generator, num_regions: int, region_len: tuple[int, int],
                   num_similar_pairs: int, similar_divergence: float,
                   num_negative_controls: int) -> dict[str, str]:
    """The panel: random regions, near-duplicates of the first
    ``num_similar_pairs`` (substitutions at ``similar_divergence``), and
    negative controls that receive no molecules."""
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


def _sizes(traffic: dict, rng: np.random.Generator):
    """The panel and the molecules drawn from ``rng`` in the simulator's
    order (regions, near-duplicates and controls, then each countable
    region's molecules with their UMIs and read counts)."""
    ref = make_reference(
        rng, int(traffic["num_regions"]), tuple(traffic["region_len"]),
        int(traffic["num_similar_pairs"]), float(traffic["similar_divergence"]),
        int(traffic["num_negative_controls"]))
    heavy = {int(k): int(v) for k, v in traffic.get("heavy", {}).items()}
    mol_lo, mol_hi = traffic["molecules_per_region"]
    rd_lo, rd_hi = traffic["reads_per_molecule"]
    molecules: list[Molecule] = []
    countable = [n for n in ref if not n.endswith(NEGATIVE_CONTROL_SUFFIXES)]
    for k, region in enumerate(countable):
        n_mol = heavy[k] if k in heavy else int(rng.integers(mol_lo, mol_hi + 1))
        for _ in range(n_mol):
            molecules.append(Molecule(
                region=region,
                umi_fwd=instantiate_iupac(rng, traffic["umi_fwd"]),
                umi_rev=instantiate_iupac(rng, traffic["umi_rev"]),
                num_reads=int(rng.integers(rd_lo, rd_hi + 1)),
            ))
    extra = traffic.get("extra_reads")
    if extra:
        ex_lo, ex_hi = extra["per_molecule"]
        tr_lo, tr_hi = extra["truncated_len"]
        q_lo, q_hi = extra["quality_shift"]
        for mol in molecules:
            n = int(rng.integers(ex_lo, ex_hi + 1))
            cut = rng.random(n) < float(extra["truncated_share"])
            length = rng.integers(tr_lo, tr_hi + 1, n)
            shift = rng.uniform(q_lo, q_hi, n)
            mol.extras = tuple((int(length[j]), 0.0) if cut[j] else (0, float(shift[j]))
                               for j in range(n))
    return ref, molecules


def _redraw(traffic: dict, ref: dict[str, str], molecules: list[Molecule],
            rng: np.random.Generator):
    """The same sizes with new content from ``rng``: each region's sequence
    at its length (a near-duplicate from its source at the traffic's
    divergence), each molecule's UMIs; regions, molecule counts and read
    counts kept."""
    names = list(ref)
    out: dict[str, str] = {}
    for name in names:
        if "_sim" in name:
            src = out[name.split("_sim")[0]]
            seq = list(src)
            n_mut = max(1, int(len(seq) * float(traffic["similar_divergence"])))
            for pos in rng.choice(len(seq), size=n_mut, replace=False):
                choices = [b for b in "ACGT" if b != seq[pos]]
                seq[pos] = choices[rng.integers(3)]
            out[name] = "".join(seq)
        else:
            out[name] = _rand_seq(rng, len(ref[name]))
    mols = [Molecule(m.region, instantiate_iupac(rng, traffic["umi_fwd"]),
                     instantiate_iupac(rng, traffic["umi_rev"]), m.num_reads, m.extras)
            for m in molecules]
    return out, mols


def generate(traffic: dict, seed: int) -> Library:
    """The library of a traffic file's parameters under ``seed``.

    Keys: ``num_regions``, ``region_len``, ``num_similar_pairs``,
    ``similar_divergence``, ``num_negative_controls`` (the panel);
    ``molecules_per_region`` and ``reads_per_molecule`` ([lo, hi]
    inclusive); ``heavy`` (optional): {countable region index: molecule
    count}, regions whose molecule count is fixed instead of drawn (the
    clonal expansion); ``extra_reads`` (optional): reads past each
    molecule's ``reads_per_molecule``, a spread of read quality and length
    that the EE and length filter decide: ``per_molecule`` ([lo, hi]), of
    which a ``truncated_share`` is cut to ``truncated_len`` ([lo, hi]
    bases from the 5' end as sequenced: under any trimmed length a region
    gives) and the rest have every base's quality lowered by a Phred shift
    drawn from ``quality_shift`` ([lo, hi]); ``umi_fwd``/``umi_rev``
    patterns; ``with_adapters``;
    ``sizes_seed`` (optional): the seed the sizes are drawn from (region
    lengths, molecules a region, reads a molecule), so that every seed
    gives a library of the same work (the extras' lengths and shifts
    included), the seed drawing its sequences, UMIs, errors, strands and
    read order. A seed equal to ``sizes_seed``
    (or no ``sizes_seed``) draws everything from one stream, as the port's
    simulator does.
    """
    sizes_seed = traffic.get("sizes_seed")
    if sizes_seed is None or int(sizes_seed) == seed:
        rng = np.random.default_rng(seed)
        ref, molecules = _sizes(traffic, rng)
    else:
        ref, molecules = _sizes(traffic, np.random.default_rng(int(sizes_seed)))
        rng = np.random.default_rng(seed)
        ref, molecules = _redraw(traffic, ref, molecules, rng)
    model = OntErrorModel()
    with_adapters = bool(traffic["with_adapters"])
    reads: list[tuple[str, str, str]] = []
    mol_of: list[int] = []
    rev_of: list[bool] = []
    extra_of: list[bool] = []
    for mi, mol in enumerate(molecules):
        template = mol.template(ref, with_adapters)
        template_rc = revcomp(template)
        for ri in range(mol.num_reads + len(mol.extras)):
            orient = "-" if rng.random() < 0.5 else "+"
            seq, qual = mutate_ont(rng, template_rc if orient == "-" else template, model)
            tag = "r"
            if ri >= mol.num_reads:
                tag = "x"
                seq, qual = _extra(seq, qual, *mol.extras[ri - mol.num_reads])
            reads.append((f"read_m{mi}_{tag}{ri} mol={mi} orient={orient}", seq, qual))
            mol_of.append(mi)
            rev_of.append(orient == "-")
            extra_of.append(tag == "x")
    order = rng.permutation(len(reads))
    return Library(reference=ref, molecules=molecules, reads=[reads[i] for i in order],
                   read_mol=np.asarray(mol_of, np.int64)[order],
                   read_rev=np.asarray(rev_of, bool)[order],
                   read_extra=np.asarray(extra_of, bool)[order])


def _extra(seq: str, qual: str, cut: int, shift: float) -> tuple[str, str]:
    """An extra read: cut to ``cut`` bases, or its qualities lowered by
    ``shift`` Phred points (rounded, at least Phred 2)."""
    if cut:
        return seq[:cut], qual[:cut]
    q = np.frombuffer(qual.encode("ascii"), np.uint8).astype(np.float64) - 33
    frac = shift - np.floor(shift)
    step = np.floor(shift) + (np.arange(len(q)) * 0.6180339887498949 % 1.0 < frac)
    q = np.clip(q - step, 2, 50).astype(np.uint8) + 33
    return seq, q.tobytes().decode("ascii")


def write_lane(lib: Library, root: str) -> tuple[str, str]:
    """``root/reference.fa`` and ``root/fastq_pass/barcode01/barcode01.fastq.gz``
    (gzip level 1); returns (reference path, fastq_pass dir)."""
    fq_dir = os.path.join(root, "fastq_pass", "barcode01")
    os.makedirs(fq_dir, exist_ok=True)
    ref_path = os.path.join(root, "reference.fa")
    with open(ref_path, "w") as fh:
        fh.write("".join(f">{name}\n{seq}\n" for name, seq in lib.reference.items()))
    with gzip.open(os.path.join(fq_dir, "barcode01.fastq.gz"), "wt", compresslevel=1) as fh:
        fh.write("".join(f"@{h}\n{s}\n+\n{q}\n" for h, s, q in lib.reads))
    return ref_path, os.path.join(root, "fastq_pass")
