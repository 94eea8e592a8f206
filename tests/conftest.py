"""Test config: run JAX on a virtual 8-device CPU mesh.

Must set the env vars before jax initializes (first import), so the
multi-device paths (mesh sharding, pair-parallel round-robin) run
without real cards.
"""

import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260817)


@pytest.fixture(scope="session")
def sig_collection(rng, tmp_path_factory):
    """Synthetic sourmash-style sig collection with controlled overlap.

    Returns (sigs_dir, {name: set(hashes)}, ksize).
    """
    from kspider_tpu.io import sigs as sigs_io

    ksize = 21
    sigs_dir = tmp_path_factory.mktemp("sigs")
    n_families = 4
    n_per_family = 6
    sig_sets = {}
    universe = np.unique(rng.integers(0, 2**63, size=220_000, dtype=np.uint64))
    rng.shuffle(universe)
    universe = universe[:200_000]
    cursor = 0
    global_core = universe[cursor : cursor + 60]  # shared by every sample
    cursor += 60
    for fam in range(n_families):
        core_size = int(rng.integers(2000, 4000))
        family_core = universe[cursor : cursor + core_size]
        cursor += core_size
        for i in range(n_per_family):
            take = rng.random(core_size) < rng.uniform(0.55, 0.95)
            own_size = int(rng.integers(500, 3000))
            own = universe[cursor : cursor + own_size]
            cursor += own_size
            hashes = np.sort(np.concatenate([global_core, family_core[take], own]))
            name = f"fam{fam}_s{i:02d}"
            sig_sets[name] = set(int(h) for h in hashes)
            sigs_io.write_sig(
                str(sigs_dir / f"{name}.sig"),
                name,
                hashes.tolist(),
                ksize,
                abundances=rng.integers(1, 30, size=len(hashes)).tolist(),
            )
    # one decoy non-matching-k entry file to exercise ksize selection
    decoy = universe[cursor : cursor + 100]
    sigs_io.write_sig(str(sigs_dir / "zz_decoy_k31.sig"), "zz_decoy_k31", decoy.tolist(), 31)
    sig_sets["zz_decoy_k31"] = None  # registered, never ingested at k=21
    return str(sigs_dir), sig_sets, ksize


def golden_model(sig_sets):
    """Independent set-arithmetic golden model, mirroring
    /root/reference/test/generate_golden_files.py semantics."""
    names = [n for n, s in sig_sets.items() if s is not None]
    lengths = {n: len(sig_sets[n]) for n in names}
    shared = {}
    min_cont, avg_cont, max_cont = {}, {}, {}
    for a in names:
        for b in names:
            if a >= b:
                continue
            common = len(sig_sets[a] & sig_sets[b])
            if not common:
                continue
            shared[(a, b)] = common
            mx = common / min(lengths[a], lengths[b])
            mn = common / max(lengths[a], lengths[b])
            av = (mx + mn) / 2
            min_cont[(a, b)] = float(f"{mn:.3f}")
            avg_cont[(a, b)] = float(f"{av:.3f}")
            max_cont[(a, b)] = float(f"{mx:.3f}")
    return lengths, shared, min_cont, avg_cont, max_cont
