"""CLI entry point: ``python -m ont_tcrconsensus_tpu_torch.qc.analysis_cli
<nano_dir> <reference.fa | name=path ...> [--libraries-csv CSV]
[--tcr-refs-csv CSV]``.

The port's copy of the JAX package's ``qc/analysis_cli.py``. The original
tool drives its post-hoc QC from a notebook (read ``libraries.csv``, loop
over the libraries, call the analysis plot and summary functions into
per-library ``outs/`` dirs); here the same loop is a command over the
pipeline's output tree, so the analysis runs headless right after the
pipeline. It reads FASTA with the port's own ``io/fastx`` and loads no
torch.

The reference may be given as repeated ``name=path`` pairs to register
several reference libraries; ``libraries.csv``'s ``ref_library_name``
column then selects the region set of each library.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        description="Post-hoc QC/analysis over a completed pipeline output tree."
    )
    parser.add_argument("nano_dir", help="The nano_tcr output dir of a pipeline run")
    parser.add_argument(
        "reference", nargs="+",
        help="Reference fasta path, or repeated name=path pairs for "
             "libraries.csv ref_library_name mapping",
    )
    parser.add_argument("--libraries-csv", default=None,
                        help="barcode,library_name,ref_library_name,threshold CSV")
    parser.add_argument("--tcr-refs-csv", default=None,
                        help="TCR composition CSV enabling the V-gene plots")
    args = parser.parse_args(argv)

    from ont_tcrconsensus_tpu_torch.io import fastx
    from ont_tcrconsensus_tpu_torch.qc import analysis

    if len(args.reference) == 1 and "=" not in args.reference[0]:
        regions = set(fastx.read_fasta_dict(args.reference[0]))
    else:
        regions = {}
        for pair in args.reference:
            name, _, path = pair.partition("=")
            if not path:
                parser.error(f"expected name=path, got {pair!r}")
            regions[name] = set(fastx.read_fasta_dict(path))

    summaries = analysis.run_all_libraries(
        args.nano_dir, regions,
        libraries_csv=args.libraries_csv,
        tcr_refs_csv=args.tcr_refs_csv,
    )
    json.dump(summaries, sys.stdout, indent=2, default=float)
    print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
