"""The port's post-hoc analysis (``qc/analysis.py``, ``qc/analysis_cli.py``)
against the JAX package's, on one JAX run's ``nano_tcr/`` tree (the
e2e ``untrimmed`` lane: seed 23, three regions, a near-duplicate pair and a
negative control, ``poa``), copied once for each package. With
``SOURCE_DATE_EPOCH=0`` (matplotlib stamps the time in a PDF otherwise)
the summaries, the CLI's stdout, ``results_summary.txt``,
``precision_at_num_subreads.tsv`` and every PDF must be byte-identical:
with one reference, with a ``libraries.csv`` mapping onto named
references (one of them with 384-well plate names, for the per-plate
heatmaps), and with ``--tcr-refs-csv`` (the V-gene plots)."""

import json
import os
import shutil

import numpy as np
import pytest

pytest.importorskip("torch")

from ont_tcrconsensus_tpu.pipeline.config import RunConfig as JConfig  # noqa: E402
from ont_tcrconsensus_tpu.pipeline.run import run_with_config as jax_run  # noqa: E402
from ont_tcrconsensus_tpu.qc import analysis as janalysis  # noqa: E402
from ont_tcrconsensus_tpu.qc import analysis_cli as jcli  # noqa: E402
from ont_tcrconsensus_tpu_torch.io import fastx, simulator  # noqa: E402
from ont_tcrconsensus_tpu_torch.qc import analysis as tanalysis  # noqa: E402
from ont_tcrconsensus_tpu_torch.qc import analysis_cli as tcli  # noqa: E402
from test_torch_e2e import LANES, _lane_dir  # noqa: E402

SIDES = {"port": (tanalysis, tcli), "jax": (janalysis, jcli)}


@pytest.fixture(autouse=True)
def _fixed_pdf_dates(monkeypatch):
    monkeypatch.setenv("SOURCE_DATE_EPOCH", "0")


@pytest.fixture(scope="module")
def run_tree(tmp_path_factory):
    """One JAX run of the lane, and the inputs of the analysis:
    references, ``libraries.csv`` and a TCR table."""
    kw = dict(LANES["untrimmed"], error_model=simulator.OntErrorModel())
    lib = simulator.simulate_library(**kw)
    root = tmp_path_factory.mktemp("analysis") / "run"
    jax_run(JConfig.from_dict(_lane_dir(root, lib, "poa", "untrimmed")))
    names = list(lib.reference)
    rng = np.random.default_rng(5)
    # a second reference library with 384-well plate names beside the lane's
    plate = {f"TCR_{p}_{'ABCP'[i % 4]}{int(c):02d}_x": "ACGT" * 50
             for i, (p, c) in enumerate(zip(rng.integers(1, 3, 8), rng.integers(1, 25, 8)))}
    fastx.write_fasta(root / "plate.fa", [*lib.reference.items(), *plate.items()])
    (root / "libraries.csv").write_text(
        "barcode,library_name,ref_library_name,log_umi_counts_filter_threshold\n"
        "barcode01,libA,lane,0.3\nbarcode02,libB,plate,\n")
    alleles = ["TRAV1-2", "TRAV12-1", "TRBV5-1", "TRBV20-1"]
    rows = ["name,TRAV_IMGT_allele_collapsed,TRBV_IMGT_allele_collapsed"]
    for name in [*names, *plate]:
        rows.append(f"{name},{alleles[int(rng.integers(0, 2))]},"
                    f"{alleles[2 + int(rng.integers(0, 2))]}")
    (root / "tcr_refs.csv").write_text("\n".join(rows) + "\n")
    return {"root": root, "reference": root / "reference.fa", "plate": root / "plate.fa",
            "names": names}


def _copies(run_tree, tmp_path, second_library: bool) -> dict[str, str]:
    """A fresh copy of the run's nano_tcr/ for each package; with
    ``second_library``, its library copied once more as ``barcode02``
    (which ``libraries.csv`` maps onto the plate reference)."""
    out = {}
    for side in SIDES:
        dst = tmp_path / side / "nano_tcr"
        shutil.copytree(run_tree["root"] / "fastq_pass" / "nano_tcr", dst)
        if second_library:
            shutil.copytree(dst / "barcode01", dst / "barcode02")
        out[side] = str(dst)
    return out


def _outs(nano: str) -> dict[str, bytes]:
    files = {}
    for dirpath, _, names in os.walk(nano):
        if "outs" not in os.path.relpath(dirpath, nano).split(os.sep):
            continue
        for name in names:
            path = os.path.join(dirpath, name)
            with open(path, "rb") as fh:
                files[os.path.relpath(path, nano)] = fh.read()
    return files


def _cli_args(run_tree, form: str) -> list[str]:
    if form == "one-reference":
        return [str(run_tree["reference"])]
    args = [f"lane={run_tree['reference']}", f"plate={run_tree['plate']}",
            "--libraries-csv", str(run_tree["root"] / "libraries.csv")]
    if form == "libraries-csv-and-tcr-refs":
        args += ["--tcr-refs-csv", str(run_tree["root"] / "tcr_refs.csv")]
    return args


@pytest.mark.parametrize("form", ["one-reference", "libraries-csv-and-tcr-refs"])
def test_the_analysis_verb_equals_jax(run_tree, tmp_path, capsys, form):
    nanos = _copies(run_tree, tmp_path, second_library=form != "one-reference")
    stdout, outs = {}, {}
    for side, (_, cli) in SIDES.items():
        assert cli.main([nanos[side], *_cli_args(run_tree, form)]) == 0
        stdout[side] = capsys.readouterr().out
        outs[side] = _outs(nanos[side])
    assert stdout["port"] == stdout["jax"]
    assert sorted(outs["port"]) == sorted(outs["jax"])
    assert [rel for rel in outs["port"] if outs["port"][rel] != outs["jax"][rel]] == []
    names = {os.path.basename(rel) for rel in outs["port"]}
    assert {"results_summary.txt", "precision_at_num_subreads.tsv", "umi_count_hist.pdf",
            "blast_id_hist.pdf", "precision_blast_id_hist.pdf",
            "log_transformed_umi_counts_hist.pdf"} <= names
    summaries = json.loads(stdout["port"])
    if form == "one-reference":
        assert sorted(summaries) == ["barcode01"]
        assert "plate_heatmap.pdf" in names
    else:
        assert sorted(summaries) == ["barcode01_libA", "barcode02_libB"]
        assert any(n.startswith("plate_heatmap_plate") for n in names)
    v_gene = {"TRAV_fold_change_over_input_barplot.pdf", "TRBV_fold_change_over_input_barplot.pdf"}
    assert (v_gene <= names) is (form == "libraries-csv-and-tcr-refs")


def test_run_all_libraries_equals_jax(run_tree, tmp_path):
    """The library call itself, under the ``libraries.csv`` mapping: its
    returned summaries and its files."""
    nanos = _copies(run_tree, tmp_path, second_library=True)
    regions = {"lane": set(fastx.read_fasta_dict(run_tree["reference"])),
               "plate": set(fastx.read_fasta_dict(run_tree["plate"]))}
    got = {side: (analysis.run_all_libraries(
                      nanos[side], regions,
                      libraries_csv=str(run_tree["root"] / "libraries.csv")),
                  _outs(nanos[side]))
           for side, (analysis, _) in SIDES.items()}
    assert got["port"][0] == got["jax"][0]
    assert got["port"][1] == got["jax"][1]
    # the lane's library finds every region; the plate library misses the
    # plate names the lane does not have
    assert got["port"][0]["barcode01_libA"]["sensitivity"] == 1.0
    assert got["port"][0]["barcode02_libB"]["sensitivity"] < 1.0


def _log(run_tree, rel: str) -> str:
    return str(run_tree["root"] / "fastq_pass" / "nano_tcr" / rel)


CALLS = {
    "parse_merged_consensus_bam_filter_log": lambda t: (
        _log(t, "barcode01/logs/merged_consensus_bam_filter.log"),),
    "parse_quantile_95_blast_id_from_self_homology_log": lambda t: (
        _log(t, "ref_homology_out_generate_region_split_dict.log"),),
    "parse_raw_nanopore_qual_from_fastq_stats": lambda t: (
        _log(t, "barcode01/logs/barcode01_fastq_stats.log"),),
    "read_counts_csv": lambda t: (_log(t, "barcode01/counts/umi_consensus_counts.csv"),),
    "read_two_column_csv": lambda t: (
        _log(t, "barcode01/logs/merged_consensus_number_of_subreads_blast_id.csv"),),
    "read_libraries_csv": lambda t: (str(t["root"] / "libraries.csv"),),
    "load_tcr_refs_csv": lambda t: (str(t["root"] / "tcr_refs.csv"),),
}


@pytest.mark.parametrize("name", sorted(CALLS))
def test_the_parsers_equal_jax(run_tree, name):
    args = CALLS[name](run_tree)
    got = getattr(tanalysis, name)(*args)
    assert got == getattr(janalysis, name)(*args)
    assert got  # each artifact is there and parses to something


def _counts(seed: int) -> dict[str, int]:
    rng = np.random.default_rng(seed)
    counts = {f"TCR_{1 + i // 96}_{'ABCDEFGH'[i % 8]}{1 + i % 12:02d}": int(c)
              for i, c in enumerate(rng.negative_binomial(5, 0.1, size=150))}
    counts.update({"NC0_full_n": 3, "NC1_v_n": 0})
    return counts


TRANSFORMS = {
    "filter_counts_on_log_umi_count_threshold": lambda c: (c, 1.3),
    "filter_counts_on_umi_quantile_threshold": lambda c: (c, 0.1),
    "negative_control_counts": lambda c: (c,),
    "fit_count_distributions": lambda c: (list(c.values()),),
    "estimate_precision_at_num_subreads": lambda c: (
        [(str(v % 7 + 1), 0.995 + (v % 6) * 0.001) for v in c.values()],),
    "v_gene_fold_change": lambda c: (
        c, {r: {"TRAV": f"TRAV{len(r) % 3}", "TRBV": "TRBV1"} for r in c}, "TRAV"),
}


@pytest.mark.parametrize("name", sorted(TRANSFORMS))
def test_the_count_transforms_and_fits_equal_jax(name):
    args = TRANSFORMS[name](_counts(17))
    assert getattr(tanalysis, name)(*args) == getattr(janalysis, name)(*args)


def test_plate_names_parse_as_in_jax():
    for name in ["TCR_3_B07_x", "TCR_1_P24", "TCR_1_Q01", "TCR_x_A01", "TCR_2_A25", "TCR_2_",
                 "TCR0001", "NC000_full_n"]:
        assert tanalysis.parse_plate_well(name) == janalysis.parse_plate_well(name), name
