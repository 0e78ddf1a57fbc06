"""Warm-serving daemon: the one-shot CLI turned into a long-lived service.

The counterpart of the JAX package's ``serve/`` on the CUDA card. A
one-shot run pays its cold costs every lane: the interpreter and torch
imports, the CUDA context, the ``nvcc`` build or build-cache load of the
two hand kernels (``csrc/sw_banded.cu``, ``csrc/pileup_forward.cu``) and
cuDNN's GRU handles. The daemon pays them once: it arms the kernel build
cache and the live plane, then runs every submitted job through the
unchanged :func:`~..pipeline.run.run_with_config` in-process, on one
explicit ``torch.device`` (the card unless ``--cpu`` or
``TCR_CONSENSUS_FORCE_CPU`` asks for the CPU). Every kernel library a job
needs is then already loaded, and its ``telemetry.json`` counts no kernel
build.

Four pieces:

- :mod:`.queue` — the bounded FIFO tenant job queue with admission control
  on the JAX package's byte model (:mod:`~..parallel.budget`), its
  metrics, the fsynced drain journal and the poison file.
- :mod:`.slices` — the slice allocator of the packed runner pool: the
  host's cards (or an explicit device list, e.g. two slices of one card)
  as a buddy pool of aligned power-of-two slices.
- :mod:`.prewarm` — warm-up launches at the declared shape buckets: the
  fused round-1 pass (kernel B1) per read-width bucket on reads drawn from
  the reference panel, and one polisher tile (kernels B2 and B3 and the
  GRUs). The port compiles nothing ahead of time; a warm-up launch builds or loads
  the kernel libraries, creates the CUDA context and the cuDNN handles.
- :mod:`.daemon` — the accept loop and its loopback control plane on the
  live server (POST ``/jobs``, GET ``/jobs`` and ``/jobs/<id>``). SIGTERM
  drains: the in-flight job stops at its next stage boundary, the queue
  is journaled, the daemon exits 143, and a restarted daemon resumes the
  journal through verified resume.
"""
