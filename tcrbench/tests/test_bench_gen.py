"""The frozen generator gives the port's simulator's libraries read for
read: the lane chip_smoke.py times (seed 33) among them. The test imports
the port; the run never does for its data."""

import json
import os

import numpy as np

from tcrbench import gen

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _traffic(name):
    with open(os.path.join(ROOT, "tcrbench", "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def test_deep_lane_seed_33_is_chip_smokes_lane():
    from ont_tcrconsensus_tpu_torch.io import simulator

    ours = gen.generate(_traffic("deep_lane"), 33)
    theirs = simulator.simulate_library(
        seed=33, num_regions=56, molecules_per_region=(8, 14), reads_per_molecule=(12, 22),
        error_model=simulator.OntErrorModel(), with_adapters=True, num_similar_pairs=6,
        similar_divergence=0.01, num_negative_controls=2)
    assert ours.reference == theirs.reference
    assert ours.reads == theirs.reads
    assert ours.true_counts == theirs.true_counts
    mol = np.array([int(h.split("mol=")[1].split()[0]) for h, _, _ in ours.reads])
    assert np.array_equal(mol, ours.read_mol)
    assert np.array_equal(np.array(["orient=-" in h for h, _, _ in ours.reads]), ours.read_rev)
    assert not ours.read_extra.any()


def test_clonal_lane_shape():
    lib = gen.generate({**_traffic("clonal_lane"), "heavy": {"0": 40}}, 2**31 + 17)
    per_region = lib.true_counts
    assert per_region["TCR0000"] == 40
    assert all(8 <= n <= 14 for r, n in per_region.items() if r != "TCR0000")
    assert all(6 <= m.num_reads <= 10 for m in lib.molecules)
    assert all(len(m.extras) <= 2 for m in lib.molecules)
    assert len(lib.reads) == sum(m.num_reads + len(m.extras) for m in lib.molecules)
    assert int(lib.read_extra.sum()) == sum(len(m.extras) for m in lib.molecules)


def test_extras_are_cut_short_or_of_lower_quality():
    lib = gen.generate({**_traffic("clonal_lane"), "heavy": {"0": 40}}, 2**31 + 17)
    cut = [c for m in lib.molecules for c, _ in m.extras if c]
    shifts = [q for m in lib.molecules for c, q in m.extras if not c]
    assert cut and shifts and all(500 <= c <= 1400 for c in cut)
    assert all(4.0 <= q <= 6.5 for q in shifts)

    def rate(i):
        q = np.frombuffer(lib.reads[i][2].encode("ascii"), np.uint8).astype(float) - 33
        return float(np.mean(10 ** (-q / 10)))

    extra = np.where(lib.read_extra)[0]
    long_extra = [i for i in extra if len(lib.reads[i][1]) > 1400]
    short = [i for i in extra if len(lib.reads[i][1]) <= 1400]
    assert len(short) == len(cut) and len(long_extra) == len(shifts)
    good = [rate(i) for i in np.where(~lib.read_extra)[0][:200]]
    low = [rate(i) for i in long_extra]
    assert max(good) < 0.03 and min(low) > 0.04 and min(low) < 0.07 < max(low)


def test_same_seed_same_library_and_large_seeds():
    t = {**_traffic("deep_lane"), "num_regions": 3, "num_similar_pairs": 1}
    a, b = gen.generate(t, 2**33 + 5), gen.generate(t, 2**33 + 5)
    assert a.reads == b.reads and a.reference == b.reference
    assert gen.generate(t, 2**33 + 6).reads != a.reads


def test_quality_strings_match_the_loop():
    rng_a, rng_b = np.random.default_rng(4), np.random.default_rng(4)
    from ont_tcrconsensus_tpu_torch.io import simulator

    template = "ACGTTTTTGCA" * 40
    assert gen.mutate_ont(rng_a, template, gen.OntErrorModel()) == simulator.mutate_ont(
        rng_b, template, simulator.OntErrorModel())


def test_every_seed_has_the_sizes_of_sizes_seed():
    t = {**_traffic("deep_lane"), "num_regions": 6, "num_similar_pairs": 2}
    a, b = gen.generate(t, 33), gen.generate(t, 2**32 + 9)
    assert [len(s) for s in a.reference.values()] == [len(s) for s in b.reference.values()]
    assert [(m.region, m.num_reads) for m in a.molecules] == [(m.region, m.num_reads)
                                                              for m in b.molecules]
    assert a.reference != b.reference and a.reads != b.reads
    for name, seq in b.reference.items():
        if "_sim" in name:
            src = b.reference[name.split("_sim")[0]]
            assert sum(x != y for x, y in zip(seq, src)) == int(len(src) * 0.01)
