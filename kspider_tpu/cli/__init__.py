"""argparse CLI mirroring the reference command surface
(/root/reference/pykSpider/kSpider2/kSpider_main.py:12-19):

sketch, index, pairwise, cluster, export (+ hidden index_kmers /
index_skipmers / index_protein), plus a ``tools`` group covering the
reference's standalone executables (sig_to_bin, sigs_to_bins, dump_sig,
dump_bin, check_bin, validate, repr_sketches).
"""

from kspider_tpu.cli.main import cli  # noqa: F401
