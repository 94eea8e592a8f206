"""kSpider-TPU: an accelerator sequence-clustering engine.

A from-scratch reimplementation of the capabilities of dib-lab/kSpider
(sketch -> k-mer color index -> pairwise containment matrix -> connected
components clustering -> export), built on JAX/XLA:

- the pairwise co-occurrence engine runs as blocked int8 matmuls with
  int32 accumulation (exact integer arithmetic via 7-bit limb
  decomposition of color weights), sharded over a ``jax.sharding.Mesh``
  with ``psum`` merges across devices (reference hot loop:
  /root/reference/src/pairwise.cpp:199-237);
- connected-components clustering runs on device as pointer-jumping label
  propagation (reference: rustworkx call in
  /root/reference/pykSpider/kSpider2/ks_clustering.py:120);
- ingestion/indexing is a sort-based postings build (reference: incremental
  color algorithm in /root/reference/src/sourmash_indexing.cpp:190-260),
  with a native C++ fast path for parsing and hashing.

On-disk artifacts are format-compatible with the reference (phmap-dump
binary layouts, namesMap/extra text files, pairwise/cluster TSVs).
"""

__version__ = "0.1.0"

from kspider_tpu.core.index import ColorIndex, build_index_from_hash_sets  # noqa: F401
