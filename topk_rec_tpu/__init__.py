"""topk_rec_tpu — a top-k recommendation framework in JAX.

A from-scratch JAX/XLA re-design of the capability set of the
``domainxz/top-k-rec`` reference (see SURVEY.md): BPR / VBPR pairwise-ranking
matrix factorization, WMF weighted-ALS, CER collaborative embedding
regression, DPM neural-encoder alternation, score-level fusion, and the
in-matrix / out-of-matrix accuracy@k evaluation protocol — all run on the
accelerator (device-side sampling, blocked batched ALS solves, chunked
scoring + masked top-k, mesh-sharded embedding tables).

Layout:
  data/      id vocabularies, ratings parsing, .dat interchange IO, datasets
  ops/       device ops: triplet sampling, batched ALS, seen-item masks
  models/    BPR, VBPR, WMF, CER, DPM + content encoders
  eval/      NumPy oracle protocol + on-device evaluator
  fusion/    late score-fusion strategies (average/rank/error/svm/bpr)
  parallel/  device meshes, sharded embedding tables, distributed steps
  native/    C++ host runtime (fast text IO, golden CPU ALS solver)
  utils/     logging, timing, config
"""

__version__ = "0.1.0"

_LAZY = {
    "BPR": "topk_rec_tpu.models.bpr",
    "VBPR": "topk_rec_tpu.models.vbpr",
    "WMF": "topk_rec_tpu.models.wmf",
    "CER": "topk_rec_tpu.models.cer",
    "DPM": "topk_rec_tpu.models.dpm",
    "Encoder": "topk_rec_tpu.models.encoders",
    "MLPEncoder": "topk_rec_tpu.models.encoders",
}

__all__ = list(_LAZY)


def __getattr__(name):
    if name in _LAZY:
        import importlib

        module = importlib.import_module(_LAZY[name])
        return getattr(module, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
