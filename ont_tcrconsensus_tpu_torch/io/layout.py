"""Per-library analysis directory layout and the verified-resume manifest.

A copy of the JAX package's ``io/layout.py``: the reference's per-library
tree, and a stage manifest that makes an existing tree resumable under
``resume=True``.

Manifest v2: ``mark_stage_done`` records sha256 + byte size for every
artifact a stage produced, and :meth:`LibraryLayout.verify_stage` checks
them before resume skips the stage (``verify_resume``: ``off`` trusts the
mark, ``fast`` checks sizes, ``full`` re-hashes). A v1 manifest (flat
``{stage: time}``) still reads, but its stages carry no checksums and are
unverifiable under ``fast``/``full``. A torn or corrupt manifest reads as
"no stages done", never a crash. The manifest write is the
``layout.manifest_write`` chaos site (``torn``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import sys
import time

from ont_tcrconsensus_tpu_torch.robustness import faults

MANIFEST_VERSION = 2

VERIFY_MODES = ("off", "fast", "full")

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
    def quarantine_path(self) -> str:
        """Per-library quarantine artifact (on_bad_record=quarantine): the
        raw bytes of every malformed input region, gzip-compressed, with
        machine-readable reasons in robustness_report.json."""
        return self._sub("quarantine.fastq.gz")

    @property
    def manifest_path(self) -> str:
        return self._sub("stage_manifest.json")

    def read_manifest(self) -> dict[str, dict]:
        """Normalized manifest: ``{stage: {"t": float, "artifacts": dict|None}}``.

        Handles both versions: v2 (``{"version": 2, "stages": {...}}``,
        per-artifact ``{"sha256", "bytes"}`` maps) and v1 (flat
        ``{stage: time}`` — normalized with ``artifacts=None``, the
        "unverifiable" marker :meth:`verify_stage` warns about).

        Corruption-tolerant: a torn/invalid manifest (the process was
        killed mid-write by a preemption, or the disk lied) means "no
        stages done" with a warning — resume then redoes the library's
        work, which is always safe, instead of crashing the whole run on
        a ``JSONDecodeError`` and bricking ``resume=true``.
        """
        try:
            with open(self.manifest_path) as fh:
                raw = fh.read()
        except FileNotFoundError:
            return {}
        except OSError as exc:
            print(f"WARNING: cannot read stage manifest {self.manifest_path} "
                  f"({exc!r}); treating as no stages done", file=sys.stderr)
            return {}
        try:
            done = json.loads(raw)
        except ValueError:
            print(f"WARNING: stage manifest {self.manifest_path} is "
                  "torn/corrupt; treating as no stages done (resume will "
                  "redo this library)", file=sys.stderr)
            return {}
        if not isinstance(done, dict):
            print(f"WARNING: stage manifest {self.manifest_path} has "
                  f"unexpected shape {type(done).__name__}; treating as no "
                  "stages done", file=sys.stderr)
            return {}
        if "version" in done:  # v2
            stages = done.get("stages")
            if not isinstance(stages, dict):
                print(f"WARNING: stage manifest {self.manifest_path} v2 has "
                      "no valid 'stages' map; treating as no stages done",
                      file=sys.stderr)
                return {}
            out: dict[str, dict] = {}
            for stage, info in stages.items():
                if (not isinstance(info, dict)
                        or not isinstance(info.get("t"), (int, float))):
                    print(f"WARNING: stage manifest {self.manifest_path} "
                          f"entry {stage!r} is malformed; dropping it "
                          "(resume will redo that stage)", file=sys.stderr)
                    continue
                out[stage] = {"t": float(info["t"]),
                              "artifacts": info.get("artifacts")}
            return out
        # v1: flat {stage: time}; artifacts unknown -> unverifiable (None).
        # Same per-entry tolerance as v2: a valid-JSON-but-garbage value
        # ({"counts": "x"}) drops that entry, never crashes resume.
        out = {}
        for stage, t in done.items():
            if not isinstance(t, (int, float)):
                print(f"WARNING: stage manifest {self.manifest_path} v1 "
                      f"entry {stage!r} is malformed; dropping it "
                      "(resume will redo that stage)", file=sys.stderr)
                continue
            out[stage] = {"t": float(t), "artifacts": None}
        return out

    def completed_stages(self) -> dict[str, float]:
        """Stage -> completion time (both manifest versions)."""
        return {stage: info["t"] for stage, info in self.read_manifest().items()}

    def mark_stage_done(self, stage: str, artifacts=()) -> None:
        """Record ``stage`` complete, checksumming its ``artifacts``.

        ``artifacts`` are the stage's output files (paths under the
        library dir); each is recorded with sha256 + byte size so a later
        resume can verify before skipping. Marking on top of a v1
        manifest upgrades the file to v2; the pre-existing stages keep
        ``artifacts: null`` ("completed by an older version — no
        checksums") and stay readable.
        """
        done = self.read_manifest()
        art: dict[str, dict] = {}
        for p in artifacts:
            p = os.fspath(p)
            sha, nbytes = sha256_file(p)
            art[os.path.relpath(p, self.library_dir)] = {
                "sha256": sha, "bytes": nbytes,
            }
        done[stage] = {"t": time.time(), "artifacts": art}
        payload = json.dumps(
            {"version": MANIFEST_VERSION, "stages": done}, indent=1
        )
        if faults.tear_write("layout.manifest_write", self.manifest_path, payload):
            return  # chaos: the "crash mid-write" already happened
        tmp = self.manifest_path + ".tmp"
        with open(tmp, "w") as fh:
            fh.write(payload)
            fh.flush()
            # fsync BEFORE the rename: os.replace is atomic in the
            # namespace but not in the page cache — without the sync a
            # power cut can leave the new name pointing at zero-length
            # data, exactly the torn state read_manifest() tolerates
            os.fsync(fh.fileno())
        os.replace(tmp, self.manifest_path)

    def stage_done(self, stage: str) -> bool:
        return stage in self.read_manifest()

    def verify_stage(self, stage: str, mode: str = "fast") -> tuple[bool, str | None]:
        """Is ``stage``'s completion trustworthy enough to skip on resume?

        Returns ``(ok, reason)``. ``off`` trusts the manifest mark alone
        (legacy blind-trust behavior); ``fast`` checks each recorded
        artifact's byte size (catches truncation/missing files for free);
        ``full`` additionally re-hashes every artifact (catches any bit
        rot). A v1 entry carries no checksums: unverifiable under
        ``fast``/``full`` — the caller warns and re-runs the stage.
        """
        if mode not in VERIFY_MODES:
            raise ValueError(f"verify_resume mode {mode!r} not in {VERIFY_MODES}")
        info = self.read_manifest().get(stage)
        if info is None:
            return False, f"stage {stage!r} not marked done"
        if mode == "off":
            return True, None
        arts = info.get("artifacts")
        if arts is None:
            return False, (f"stage {stage!r} was completed by a v1 manifest "
                           "(no checksums recorded) — unverifiable")
        if not isinstance(arts, dict):
            # bit rot INSIDE valid JSON: same never-crash discipline as
            # read_manifest — unverifiable, the caller warns and re-runs
            return False, (f"stage {stage!r} artifacts record is malformed "
                           "— unverifiable")
        for rel, meta in arts.items():
            if not isinstance(meta, dict):
                return False, (f"artifact {rel} checksum record is malformed "
                               "— unverifiable")
            path = os.path.join(self.library_dir, rel)
            try:
                size = os.path.getsize(path)
            except OSError:
                return False, f"artifact {rel} is missing"
            if size != meta.get("bytes"):
                return False, (f"artifact {rel} size {size} != recorded "
                               f"{meta.get('bytes')}")
            if mode == "full":
                sha, _ = sha256_file(path)
                if sha != meta.get("sha256"):
                    return False, (f"artifact {rel} sha256 {sha[:12]}... != "
                                   f"recorded {str(meta.get('sha256'))[:12]}...")
        return True, None


def library_name_from_fastq(fastq: str | os.PathLike[str]) -> str:
    """'/path/barcode01.fastq.gz' -> 'barcode01'."""
    return os.path.basename(os.fspath(fastq)).split(".")[0]


def init_library_dir(
    fastq: str | os.PathLike[str],
    nano_dir: str | os.PathLike[str],
    resume: bool = False,
) -> LibraryLayout:
    """Create (or, with resume, reuse) the per-library tree."""
    library = library_name_from_fastq(fastq)
    library_dir = os.path.join(os.fspath(nano_dir), library)
    if os.path.exists(library_dir) and not resume:
        raise FileExistsError(
            f"{library_dir} exists; pass resume=True to continue a previous run"
        )
    os.makedirs(library_dir, exist_ok=True)
    for sub in SUBDIRS:
        os.makedirs(os.path.join(library_dir, sub), exist_ok=True)
    return LibraryLayout(library=library, library_dir=library_dir)
