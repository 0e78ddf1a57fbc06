"""Per-library analysis directory layout.

A copy of the JAX package's ``io/layout.py`` tree and stage manifest
(v2: sha256 + byte size per artifact), without its fault-injection hooks.
The port does not resume yet; it records the manifest so a later slice's
resume reads the same file.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import time

MANIFEST_VERSION = 2

SUBDIRS = (
    "logs",
    "align",
    "region_cluster_fasta",
    "umi_fasta",
    "clustering",
    "fasta",
    "clustering_consensus",
    "region_fasta",
    "consensus_umi_fasta",
    "counts",
)


def sha256_file(path: str | os.PathLike[str]) -> tuple[str, int]:
    """(hex sha256, byte size) of a file, streamed in 1 MiB chunks."""
    h = hashlib.sha256()
    n = 0
    with open(path, "rb") as fh:
        while True:
            block = fh.read(1 << 20)
            if not block:
                break
            h.update(block)
            n += len(block)
    return h.hexdigest(), n


@dataclasses.dataclass(frozen=True)
class LibraryLayout:
    library: str
    library_dir: str

    def _sub(self, name: str) -> str:
        return os.path.join(self.library_dir, name)

    @property
    def logs(self) -> str:
        return self._sub("logs")

    @property
    def region_cluster_fasta(self) -> str:
        return self._sub("region_cluster_fasta")

    @property
    def umi_fasta(self) -> str:
        return self._sub("umi_fasta")

    @property
    def clustering(self) -> str:
        return self._sub("clustering")

    @property
    def fasta(self) -> str:
        return self._sub("fasta")

    @property
    def clustering_consensus(self) -> str:
        return self._sub("clustering_consensus")

    @property
    def region_fasta(self) -> str:
        return self._sub("region_fasta")

    @property
    def consensus_umi_fasta(self) -> str:
        return self._sub("consensus_umi_fasta")

    @property
    def counts(self) -> str:
        return self._sub("counts")

    @property
    def manifest_path(self) -> str:
        return self._sub("stage_manifest.json")

    def read_manifest(self) -> dict[str, dict]:
        """``{stage: {"t": float, "artifacts": dict}}``; {} when absent."""
        try:
            with open(self.manifest_path) as fh:
                done = json.load(fh)
        except FileNotFoundError:
            return {}
        return dict(done.get("stages", {}))

    def mark_stage_done(self, stage: str, artifacts=()) -> None:
        """Record ``stage`` complete, checksumming its ``artifacts``."""
        done = self.read_manifest()
        art: dict[str, dict] = {}
        for p in artifacts:
            p = os.fspath(p)
            sha, nbytes = sha256_file(p)
            art[os.path.relpath(p, self.library_dir)] = {
                "sha256": sha, "bytes": nbytes,
            }
        done[stage] = {"t": time.time(), "artifacts": art}
        payload = json.dumps({"version": MANIFEST_VERSION, "stages": done}, indent=1)
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(payload)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, self.manifest_path)


def library_name_from_fastq(fastq: str | os.PathLike[str]) -> str:
    """'/path/barcode01.fastq.gz' -> 'barcode01'."""
    return os.path.basename(os.fspath(fastq)).split(".")[0]


def init_library_dir(
    fastq: str | os.PathLike[str],
    nano_dir: str | os.PathLike[str],
) -> LibraryLayout:
    """Create the per-library tree; refuses an existing one."""
    library = library_name_from_fastq(fastq)
    library_dir = os.path.join(os.fspath(nano_dir), library)
    if os.path.exists(library_dir):
        raise FileExistsError(f"{library_dir} exists")
    os.makedirs(library_dir)
    for sub in SUBDIRS:
        os.makedirs(os.path.join(library_dir, sub), exist_ok=True)
    return LibraryLayout(library=library, library_dir=library_dir)
