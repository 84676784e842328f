"""The launch geometry of the GroupNorm kernels K3/K4 (``ops.group_norm.plan``)
at every GroupNorm site of the main path, fp32 and bf16, forward and backward.

``plan`` is a function of shapes only, so it is checked here on the CPU: the
channel blocks hold whole groups and cover C, every resident tile fits the
card's shared memory, clusters have at most 16 CTAs, the scratch of the
two-launch geometry has its size, and the geometry at each site is the one
chosen from the H100 measurements in PERF.md: one launch (resident) at every
site of 64x64 and below, except the backward at 64x64 with C=768 and, in
fp32, C=1024; two launches (split) at 128x128 and 256x256, where a tile of
at most 64 KB in clusters of at most 8 does not hold a group.
"""

import pytest
import torch

from chip_smoke import counted, main_path_sites
from osmosis_tpu_torch.models.unet import UNetConfig
from osmosis_tpu_torch.ops import group_norm as G
from osmosis_tpu_torch.utils import profiling

SM_COUNT = 132  # H100 SXM
SITES = sorted(counted(main_path_sites(UNetConfig())[0]).items())


SPLIT_SITES = {(256, 128), (256, 256), (512, 128), (512, 256), (768, 128)}


def _expected_geometry(c, h, itemsize, bwd):
    split = set(SPLIT_SITES)
    if bwd:
        split |= {(768, 64), (1024, 64)} if itemsize == 4 else {(768, 64)}
    return "split" if (c, h) in split else "resident"


def _check(p, b, c, h, w, itemsize, tensors, sums):
    cpg = c // G.NUM_GROUPS
    lanes = 16 // itemsize
    assert p.cblk % cpg == 0 and p.n_cblk * p.cblk == c  # whole groups covering C
    assert (p.cblk * itemsize) % 16 == 0
    assert p.cblk * itemsize >= (G.RESIDENT_ROW_BYTES if p.geometry == "resident"
                                 else G.SPLIT_ROW_BYTES)
    cv = p.cblk // lanes
    assert p.threads % cv == 0
    assert p.threads <= (G.MAX_THREADS if p.geometry == "resident" else G.SPLIT_THREADS)
    assert p.threads // cv <= p.px  # no more rows of threads than pixels
    assert p.geometry == "resident" or p.cblk <= p.threads
    assert p.chunks * p.px >= h * w > (p.chunks - 1) * p.px
    assert p.smem == G.smem_bytes(p.geometry, tensors, p.cblk, lanes, p.threads, p.px, sums)
    assert p.smem <= G.SMEM_MAX
    if p.geometry == "resident":
        assert p.cluster == p.chunks and p.cluster in (1, 2, 4, 8)
        assert p.tile == p.px * p.cblk * itemsize * tensors <= G.TILE_BUDGET
        assert p.scratch == 0 and p.kernels == 1
    else:
        assert p.cluster == 1 and p.tile == 0 and p.kernels == 2
        assert p.scratch == sums * b * p.chunks * c
        assert p.px % (p.threads // cv) == 0  # whole rows of threads per chunk


@pytest.mark.parametrize("itemsize", [4, 2], ids=["fp32", "bf16"])
@pytest.mark.parametrize("site", [s for s, _ in SITES], ids=lambda s: "C{}_{}x{}_{}".format(*s))
def test_plan_at_every_main_path_site(site, itemsize):
    c, h, w, mode = site
    for bwd in (False, True):
        tensors = 2 if bwd else 1
        for sums in ((2, 4) if (bwd and mode == "film") else (2,)):
            p = G.plan(1, c, h, w, itemsize, SM_COUNT, tensors, sums)
            _check(p, 1, c, h, w, itemsize, tensors, sums)
            assert p.geometry == _expected_geometry(c, h, itemsize, bwd), (bwd, sums, p)


def test_the_sites_are_the_main_paths():
    assert len(SITES) == 31 and sum(n for _, n in SITES) == 101
    assert sorted({c // 32 for (c, _, _, _), _ in SITES}) == [8, 16, 24, 32, 48, 64]


def test_plan_at_the_largest_sites():
    # 256x256, C=256, fp32 forward: two launches, blocks of 4 groups (128
    # bytes of a row), 2 CTAs an SM: 33 chunks of 2016 pixels
    p = G.plan(1, 256, 256, 256, 4, SM_COUNT)
    assert (p.geometry, p.cblk, p.n_cblk, p.chunks, p.px) == ("split", 32, 8, 33, 2016)
    assert p.n_cblk * p.chunks <= G.SPLIT_CTAS_PER_SM * SM_COUNT
    assert p.scratch == 2 * 33 * 256
    # 128x128, C=768 (24 channels a group) fp32 backward: 128-byte lines need
    # 4 groups (384 bytes) a block
    p = G.plan(1, 768, 128, 128, 4, SM_COUNT, tensors=2, sums=4)
    assert (p.geometry, p.cblk, p.threads) == ("split", 96, 240)
    # 32x32, C=1536 fp32 backward: resident, clusters of 8 with 48 KB tiles
    p = G.plan(1, 1536, 32, 32, 4, SM_COUNT, tensors=2)
    assert (p.geometry, p.cluster, p.tile, p.threads) == ("resident", 8, 49152, 120)
    # the deep sites: one row of threads per pixel, 8 pixels a CTA
    p = G.plan(1, 1024, 8, 8, 2, SM_COUNT)
    assert (p.geometry, p.cluster, p.px, p.threads) == ("resident", 8, 8, 32)
    # clusters of 16 allowed: the 256x256 C=256 bf16 forward stays split (its
    # tiles would be 128 KB, over TILE_BUDGET); at 64x64 it takes 16 CTAs
    p = G.plan(1, 256, 256, 256, 2, SM_COUNT, max_cluster=16)
    assert p.geometry == "split"
    p = G.plan(1, 256, 64, 64, 2, SM_COUNT, max_cluster=16)
    assert (p.geometry, p.cluster) == ("resident", 16)


@pytest.mark.parametrize("b", [1, 2, 4])
def test_plan_fills_the_card_and_caps_the_cluster(b):
    for (c, h, w, _), _n in SITES:
        for itemsize in (4, 2):
            p = G.plan(b, c, h, w, itemsize, SM_COUNT)
            _check(p, b, c, h, w, itemsize, 1, 2)
            if p.geometry == "resident" and p.cluster < G.MAX_CLUSTER and p.cluster < h * w:
                assert b * p.n_cblk * p.cluster >= SM_COUNT
            for cap in (8, 4, 1, 0):
                q = G.plan(b, c, h, w, itemsize, SM_COUNT, max_cluster=cap)
                _check(q, b, c, h, w, itemsize, 1, 2)
                assert q.cluster <= max(cap, 1)
                assert cap > 0 or q.geometry == "split"


def test_plan_rejects_what_the_kernels_do_not_take():
    with pytest.raises(ValueError):
        G.plan(1, 48, 4, 4, 4, SM_COUNT)  # not a multiple of 32 channels
    with pytest.raises(ValueError):
        # 63 bf16 channels a group: the narrowest 16-byte block of whole groups
        # is 8 groups, 504 channels, wider than a split CTA's 252 threads
        G.plan(1, 32 * 63, 256, 256, 2, SM_COUNT)
    # 3 channels a group: blocks of 8 groups (24 channels, 96 bytes) in fp32
    p = G.plan(2, 96, 5, 5, 4, SM_COUNT)
    assert p.cblk == 24 and p.geometry == "resident"
    _check(p, 2, 96, 5, 5, 4, 1, 2)


def test_wrappers_on_the_cpu_do_not_plan_or_count():
    kernels = lambda: tuple(profiling.counters()[f"{w}.kernel_launches"]  # noqa: E731
                            for w in ("group_norm_forward", "group_norm_backward"))
    before = kernels()
    x = torch.randn(1, 64, 4, 4).contiguous(memory_format=torch.channels_last)
    w, b = torch.ones(64), torch.zeros(64)
    y, m, i = G.group_norm_forward(x, w, b, silu=True)
    G.group_norm_backward(torch.ones_like(y), x, w, b, None, None, True, m, i, param_grads=False)
    assert kernels() == before
