"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Marked ``cuda``: a CUDA kernel has no interpret mode, so these skip
on a machine without a card (run them there with
``python -m pytest --noconftest tests/test_torch_cuda.py -q`` where JAX,
which tests/conftest.py imports, is not installed; ``python3 chip_smoke.py``
checks the same kernels at the main path's shapes)."""

import numpy as np
import pytest
import torch

from softgroup_tpu_torch.data.synthetic import collate_scenes, make_room_scene
from softgroup_tpu_torch.ops import conv_kernel as ck
from softgroup_tpu_torch.ops import gather_kernel as gk
from softgroup_tpu_torch.ops import join_kernel as jk
from softgroup_tpu_torch.ops import norm_kernel as nk
from softgroup_tpu_torch.ops.grouping import offsets
from softgroup_tpu_torch.ops.rulebook import (build_downsample_np,
                                              build_subm_rules_np)
from softgroup_tpu_torch.ops.voxelize import voxelize_np
from softgroup_tpu_torch.time_kernels import (BN_EPS, BN_MOMENTUM, bn_case,
                                              bn_faults, bn_run)

pytestmark = pytest.mark.cuda
INT_MAX = 2 ** 31 - 1


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('k,cin,cout', [(27, 6, 32), (27, 384, 192),
                                        (8, 32, 64), (27, 224, 224),
                                        (27, 1, 32)])
def test_rulebook_conv(dev, dtype, k, cin, cout):
    g = torch.Generator(device=dev).manual_seed(k + cin)
    f = torch.randn(3000, cin, device=dev, generator=g).to(dtype)
    w = (torch.randn(k, cin, cout, device=dev, generator=g) * 0.1).to(dtype)
    r = torch.randint(-3000, 3000, (k, 2500), device=dev, generator=g).int()
    got = ck.rulebook_conv(f, w, r).double()
    want = ck.rulebook_conv_plain(f, w, r).double()
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 2e-5) \
        * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol


def _room_rulebooks():
    """(subm rules (27, V), down rules (8, V_coarse)) of a surface-sampled
    room, built by the port's host rulebook code."""
    scene = make_room_scene(np.random.RandomState(3), n_points=12000,
                            n_instances=4)
    data = collate_scenes([scene], scale=20.0)
    vox, _, _ = voxelize_np(data['coords'])
    subm = build_subm_rules_np(vox, data['spatial_shape'])
    _, down, _, _ = build_downsample_np(vox)
    return subm, down


def _padded(rules: np.ndarray, pad: int) -> np.ndarray:
    """``rules`` with ``pad`` columns of -1 appended (a capacity's padded
    tail: whole tiles where every tap misses)."""
    return np.concatenate([rules, np.full((rules.shape[0], pad), -1,
                                          np.int32)], 1)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('fill', [1, None], ids=['split1', 'split'])
@pytest.mark.parametrize('case,cin,cout', [
    ('subm', 6, 32), ('subm', 32, 32), ('subm', 224, 224),
    ('subm', 384, 192), ('down', 32, 64), ('subm_grad', 32, 64),
    ('subm', 7, 19), ('empty', 32, 32), ('subm', 1, 32)])
def test_rulebook_conv_room(dev, monkeypatch, dtype, fill, case, cin, cout):
    """K1 on a room's rulebooks: v_out not a multiple of 64, a padded tail
    of all-miss tiles, the rules a column slice of a wider table, one
    block per tile (``fill`` 1) or a tile's steps cut over several; the
    transposed, flipped weights of the subm feature gradient; odd widths;
    an all -1 rulebook; the SemanticKITTI input conv (Cin 1: remission
    alone, a 2-byte bf16 row)."""
    if fill is not None:   # bf16 and f32 grid targets
        monkeypatch.setattr(ck, '_K1_FILL_BLOCKS', fill)
        monkeypatch.setattr(ck, '_FILL_BLOCKS', fill)
    subm, down = _room_rulebooks()
    rules = down if case == 'down' else subm
    rules = _padded(rules, 151 if (rules.shape[1] + 150) % 64 == 0 else 150)
    if case == 'empty':
        rules = np.full_like(rules, -1)
    assert rules.shape[1] % 64 != 0
    v_in = int(rules.max()) + 1 if case != 'empty' else 100
    g = torch.Generator(device=dev).manual_seed(cin * 1000 + cout)
    f = torch.randn(v_in, cin, device=dev, generator=g).to(dtype)
    if case == 'subm_grad':   # as _SubmConv.backward calls it
        w = torch.randn(rules.shape[0], cout, cin, device=dev, generator=g)
        w = (w * 0.1).to(dtype).transpose(1, 2).flip(0)
    else:
        w = (torch.randn(rules.shape[0], cin, cout, device=dev,
                         generator=g) * 0.1).to(dtype)
    wide = torch.from_numpy(_padded(rules, 5)).to(dev)
    r = wide[:, :rules.shape[1]]          # row stride != v_out
    got = ck.rulebook_conv(f, w, r).double()
    want = ck.rulebook_conv_plain(f, w, r).double()
    assert got.shape == (rules.shape[1], cout)
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 2e-5) \
        * max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol
    if case == 'empty':
        assert not got.any()


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('fill', [1, None], ids=['split1', 'split'])
@pytest.mark.parametrize('case,cin,cout', [
    ('subm', 32, 32), ('subm', 6, 32), ('subm', 224, 224), ('subm', 7, 19),
    ('subm', 1, 32), ('subm_grad', 32, 64)])
def test_rulebook_conv_row_order(dev, monkeypatch, dtype, fill, case, cin,
                                 cout):
    """K1 on a room's rulebook grouped by hit mask (``hit_orders``, built
    on the card as on the CPU), each row written back by ``rows``: equal
    to the natural call bit for bit where a tile is one block (and for
    f32, whose split cuts the tap range alike), within K1's tolerance of
    it where a bf16 tile's steps are cut over several blocks."""
    from softgroup_tpu_torch.ops.sparse_conv import hit_orders
    if fill is not None:
        monkeypatch.setattr(ck, '_K1_FILL_BLOCKS', fill)
        monkeypatch.setattr(ck, '_FILL_BLOCKS', fill)
    subm, _ = _room_rulebooks()
    rules_h = torch.from_numpy(_padded(subm, 150))
    r = rules_h.to(dev)
    rows, grouped = hit_orders([r])[0]
    rows_h, grouped_h = hit_orders([rules_h])[0]
    assert torch.equal(rows.cpu(), rows_h)
    assert torch.equal(grouped.cpu(), grouped_h)
    g = torch.Generator(device=dev).manual_seed(cin * 1000 + cout + 7)
    f = torch.randn(subm.shape[1], cin, device=dev, generator=g).to(dtype)
    if case == 'subm_grad':   # as _SubmConv.backward calls it
        w = torch.randn(27, cout, cin, device=dev, generator=g)
        w = (w * 0.1).to(dtype).transpose(1, 2).flip(0)
    else:
        w = (torch.randn(27, cin, cout, device=dev, generator=g)
             * 0.1).to(dtype)
    got = ck.rulebook_conv(f, w, grouped, rows=rows)
    natural = ck.rulebook_conv(f, w, r)
    want = ck.rulebook_conv_plain(f, w, r).double()
    tol = (2.0 ** -7 if dtype == torch.bfloat16 else 2e-5) \
        * max(1.0, float(want.abs().max()))
    assert float((got.double() - want).abs().max()) <= tol
    if fill == 1 or dtype == torch.float32:
        assert torch.equal(got, natural)
    else:
        assert float((got.double() - natural.double()).abs().max()) <= tol


def test_hit_orders_card_equals_cpu(dev):
    """The order's build on the card (the masks, one stable sort, the
    grouped table) gives the CPU's rows and grouped rulebooks for several
    levels at once, a column slice of a wider table among them."""
    from softgroup_tpu_torch.ops.sparse_conv import hit_orders
    subm, _ = _room_rulebooks()
    wide = torch.from_numpy(_padded(subm, 300))
    levels = [torch.from_numpy(_padded(subm, 150)), wide[:, :subm.shape[1]],
              torch.from_numpy(subm[:, ::3].copy())]
    on_card = hit_orders([r.to(dev) for r in levels])
    for (rows, grouped), (rows_h, grouped_h) in zip(on_card,
                                                    hit_orders(levels)):
        assert torch.equal(rows.cpu(), rows_h)
        assert torch.equal(grouped.cpu(), grouped_h)


def test_backbone_row_order_bitwise(dev, monkeypatch):
    """A bf16 backbone forward and backward on the card on the row orders
    and on the identity orders, one block a tile: outputs and every
    parameter's gradient bit for bit."""
    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.model.softgroup import Capacities, SoftGroupNet
    from softgroup_tpu_torch.ops import geometry
    monkeypatch.setattr(ck, '_K1_FILL_BLOCKS', 1)
    scenes = [make_room_scene(np.random.RandomState(40 + i), n_points=12000,
                              n_instances=4) for i in range(2)]
    caps = Capacities(points=24576, voxels=(16384, 8192, 4096, 2048),
                      grouping_points=8192, proposals=32,
                      proposal_entries=8192, instances=32,
                      inst_voxels=(2048, 512), grouping_cells=4096)
    cfg = entry.train_cfg()
    cfg.num_blocks = len(caps.voxels)
    pyramid = entry.build_train_batch(scenes, cfg, caps, scale=20.0).pyramid
    x = torch.randn(caps.voxels[0], 6, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(4))

    def run():
        net = SoftGroupNet(channels=16, num_blocks=4, semantic_classes=20,
                           instance_classes=18, bf16=True,
                           generator=torch.Generator().manual_seed(0))
        net = net.to(dev)
        out = net.backbone(x, pyramid)
        sum(o.float().sum() for o in out[:2]).backward()
        return out, [p.grad for p in net.parameters() if p.grad is not None]
    got, got_g = run()
    monkeypatch.setattr(geometry, 'hit_orders', lambda rulebooks: [
        (torch.arange(r.shape[1], dtype=torch.int32, device=r.device), r)
        for r in rulebooks])
    want, want_g = run()
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert len(got_g) == len(want_g) > 0
    for a, b in zip(got_g, want_g):
        assert torch.equal(a, b)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32,
                                   torch.int32])
def test_row_gather_exact(dev, dtype):
    src = (torch.randn(5000, 35, device=dev) * 100).to(dtype)
    idx = torch.randint(-10, 5010, (20000,), device=dev)
    assert torch.equal(gk.row_gather(src, idx), gk.row_gather_plain(src, idx))


def _gather_src(case: str, dev):
    """(source, output rows) of one K2 card case."""
    g = torch.Generator(device=dev).manual_seed(len(case))

    def f32(n, c, off=0):   # (n, c) f32, ``off`` elements past alignment
        big = torch.randn(n * c + off, device=dev, generator=g) * 100
        return big[off:].view(n, c)
    n_out = 100003
    if case == 'labels int32':       # 1-D, 4-byte rows
        src = torch.randint(-1, 16384, (16385,), device=dev, generator=g,
                            dtype=torch.int32)
    elif case == 'entries f32':      # (P, 4) f32: 16-byte rows
        src = torch.randn(30000, 4, device=dev, generator=g)
    elif case == 'features bf16':    # (V, 32) bf16: 64-byte rows
        src = torch.randn(20000, 32, device=dev, generator=g).bfloat16()
    elif case == 'bytes uint8':      # 3-byte rows
        src = torch.randint(0, 256, (7000, 3), device=dev, generator=g,
                            dtype=torch.uint8)
    elif case == 'top_c int64':      # 1-D, 8-byte rows
        src = torch.randint(-5, 20, (9000,), device=dev, generator=g)
    elif case == 'unaligned bf16':   # a view 2 bytes off 16-byte alignment
        big = torch.randn(20000 * 32 + 1, device=dev, generator=g)
        src = big.bfloat16()[1:].view(20000, 32)
    elif case == 'unaligned int32':  # 1-D, 4 bytes off
        src = torch.arange(16386, device=dev, dtype=torch.int32)[1:]
    elif case.endswith('-byte') and 'f32' in case:   # 12-, 72-, 76-, 92-
        src = f32(9000, int(case.split()[2][:-5]) // 4)   # and 140-byte rows
    elif case == 'word bf16 14-byte':
        src = f32(9000, 7).bfloat16()
    elif case == 'word f32 4 bytes off':   # 72-byte rows: 4-byte words
        src = f32(9000, 18, 1)
    elif case == 'word f32 8 bytes off':   # 72-byte rows: 8-byte words
        src = f32(9000, 18, 2)
    elif case == 'word below one tile':    # 7 rows of 140 bytes
        src, n_out = f32(500, 35), 7
    elif case == 'word ragged last tile':  # 92092 bytes: a last tile
        src, n_out = f32(5000, 23), 1001   # ending inside a 16-byte word
    elif case == 'empty index':
        src, n_out = f32(500, 35), 0
    else:
        raise ValueError(case)
    return src, n_out


WORD_CASES = ['word f32 12-byte', 'word f32 72-byte', 'word f32 76-byte',
              'word f32 92-byte', 'word f32 140-byte', 'word bf16 14-byte',
              'word f32 4 bytes off', 'word f32 8 bytes off',
              'word below one tile', 'word ragged last tile', 'empty index']


@pytest.mark.parametrize('idx_kind', ['int32', 'int64', 'int32 view'])
@pytest.mark.parametrize('case', ['labels int32', 'entries f32',
                                  'features bf16', 'bytes uint8',
                                  'top_c int64', 'unaligned bf16',
                                  'unaligned int32'] + WORD_CASES)
def test_row_gather_cases(dev, case, idx_kind):
    """K2 exact against its plain version on every path of the kernel:
    rows of 1-8 bytes (16 output bytes a thread, n_out not a multiple of
    4, so a ragged tail), 16- and 64-byte rows, odd 3-byte rows, unaligned
    sources, int32 / int64 indices and an unaligned index view, with
    out-of-range indices at both ends (clamped).  The word route (8 or
    16 KB output tiles): the paths' 12-, 72-, 76-, 92- and 140-byte f32
    rows, a 14-byte bf16 row, 72-byte rows 4 and 8 bytes off 16-byte
    alignment (4- and 8-byte words), fewer rows than a tile, and a last
    tile that ends inside a 16-byte word; an empty index gives an empty
    output and launches nothing."""
    src, n_out = _gather_src(case, dev)
    n = src.shape[0]
    g = torch.Generator(device=dev).manual_seed(7)
    idx = torch.randint(-50, n + 50, (n_out,), device=dev, generator=g)
    idx[:3] = torch.tensor([-2 ** 40, 2 ** 40, n], device=dev)[:n_out]
    if idx_kind == 'int32 view':     # 4 bytes off 16-byte alignment
        idx = torch.cat([idx[:1], idx]).to(torch.int32)[1:]
    elif idx_kind == 'int32':
        idx = idx.clamp(-2 ** 31, 2 ** 31 - 1).to(torch.int32)
    launches = gk.row_gather.launches
    got = gk.row_gather(src, idx)
    assert got.data_ptr() % 16 == 0
    assert torch.equal(got, gk.row_gather_plain(src, idx))
    assert gk.row_gather.launches == launches + (n_out > 0)


def test_cell_join_exact(dev):
    rng = np.random.RandomState(0)
    m = 4096
    cc = rng.randint(0, 30, (6000, 3))
    key = np.unique((cc[:, 0] * 30 + cc[:, 1]) * 30 + cc[:, 2])[:m - 100]
    keys = np.full(m, INT_MAX, np.int32)
    keys[:len(key)] = key
    coord = np.zeros((m, 3), np.int32)
    coord[:len(key)] = np.stack([key // 900, (key // 30) % 30, key % 30], 1)
    cen = ((coord + rng.rand(m, 3)) * 0.04).astype(np.float32)
    args = [torch.from_numpy(a).to(dev) for a in (keys, cen, coord)]
    dims = torch.tensor([32, 30, 30], dtype=torch.int32, device=dev)
    got = jk.cell_neighbor_join(*args, dims, offsets(1), 0.04)
    assert torch.equal(got, jk.cell_neighbor_join_plain(*args, dims,
                                                        offsets(1), 0.04))
    assert int((got >= 0).sum()) > 1000


def _scan_cells(seed: int = 5, n_points: int = 60000):
    """(keys, ccoord, centroid, dims) of the cells of a room scan as the
    grouping builds them: 4 cm cells of the points, three groups (class %
    3) folded into x, keys ((g*d0 + x)*d1 + y)*d2 + z sorted, dims the
    largest cell + 2 (d1*d2 in the thousands), centroids the cells' means."""
    xyz, _, sem, _ = make_room_scene(np.random.RandomState(seed),
                                     n_points=n_points, n_instances=8)
    cell = np.floor((xyz - xyz.min(0)) / 0.04).astype(np.int64)
    group = np.maximum(sem, 0) % 3
    d = cell.max(0) + 2
    key = ((group * d[0] + cell[:, 0]) * d[1] + cell[:, 1]) * d[2] \
        + cell[:, 2]
    uk, inv = np.unique(key, return_inverse=True)
    cnt = np.bincount(inv)
    cen = np.stack([np.bincount(inv, xyz[:, k]) for k in range(3)], 1) \
        / cnt[:, None]
    cc = np.stack([(uk // (d[1] * d[2])) % d[0], (uk // d[2]) % d[1],
                   uk % d[2]], 1)
    return uk, cc, cen.astype(np.float32), d


def _cell_input(case: str):
    """(keys, centroid, ccoord, dims, radius) of one K3 card case, numpy;
    keys sorted, INT_MAX padded."""
    rng = np.random.RandomState(len(case))
    radius = 0.04
    if case in ('scan layout', 'ragged'):
        key, cc, cen, d = _scan_cells()
        if case == 'ragged':    # m = 3037: not a multiple of any tile
            key, cc, cen = key[:2900], cc[:2900], cen[:2900]
    elif case == 'sparse beside full':  # a sparse slab beside a full one:
        d = np.array([10, 134, 67])       # dx = +-1 brackets of ~d1*d2 rows
        yz = np.stack(np.meshgrid(np.arange(134), np.arange(67),
                                  indexing='ij'), -1).reshape(-1, 2)
        sparse = [np.concatenate([np.full((60, 1), x), yz[np.sort(
            rng.choice(len(yz), 60, replace=False))]], 1) for x in (4, 5)]
        cc = np.concatenate(sparse + [np.concatenate(
            [np.full((len(yz), 1), 6), yz], 1)])
        key = (cc[:, 0] * d[1] + cc[:, 1]) * d[2] + cc[:, 2]
        cen = ((cc + rng.rand(*cc.shape)) * 0.04).astype(np.float32)
    elif case in ('dense', 'gate ties', 'duplicate keys'):
        d = np.array([12, 12, 12])   # two groups of full 12^3 grids
        key = np.arange(2 * 12 ** 3)
        cc = np.stack([(key // 144) % 12, (key // 12) % 12, key % 12], 1)
        if case == 'gate ties':   # axis neighbours at exactly the radius,
            radius = 0.5            # or one ulp of a coordinate off it
            cen = (cc * 0.5 + 4.0).astype(np.float32)
            step = rng.randint(-1, 2, cen.shape)
            cen = np.where(step > 0, np.nextafter(cen, np.float32(np.inf)),
                           np.where(step < 0, np.nextafter(
                               cen, np.float32(-np.inf)), cen))
        else:
            cen = ((cc + 0.5 + 0.6 * (rng.rand(*cc.shape) - 0.5))
                   * 0.04).astype(np.float32)
        if case == 'duplicate keys':   # the first of equal keys matches
            key, cc, cen = (np.repeat(a, 2, axis=0) for a in (key, cc, cen))
    elif case == 'all padding':
        key, cc = np.zeros(0, np.int64), np.zeros((0, 3), np.int64)
        cen, d = np.zeros((0, 3), np.float32), np.array([20, 20, 20])
    elif case == 'one row':
        key, cc = np.array([5 * 400 + 5 * 20 + 5]), np.array([[5, 5, 5]])
        cen, d = np.full((1, 3), 0.2, np.float32), np.array([20, 20, 20])
    elif case == 'int32 edge':   # queries beyond the int32 ends wrap, as
        d = np.array([40, 100, 100])  # the plain version's int32 sum
        key = np.sort(np.concatenate([
            INT_MAX - 1 - rng.choice(30000, 3000, replace=False),
            rng.choice(30000, 2000, replace=False) - 2 ** 31]))
        cc = rng.randint(0, 40, (len(key), 3)) % d
        cen = (rng.rand(len(key), 3) * 0.01).astype(np.float32)
        radius = 1.0
    else:
        raise ValueError(case)
    pad = {'all padding': 4099, 'one row': 0, 'ragged': 137,
           'dense': 0, 'gate ties': 0}.get(case, 1001)
    m = len(key) + pad
    keys = np.full(m, INT_MAX, np.int64)
    keys[:len(key)] = key
    ccoord = np.zeros((m, 3), np.int64)
    ccoord[:len(key)] = cc
    centroid = np.zeros((m, 3), np.float32)
    centroid[:len(key)] = cen
    return (keys.astype(np.int32), centroid, ccoord.astype(np.int32),
            np.asarray(d, np.int32), radius)


@pytest.mark.parametrize('block', [32, 64, 128, 256])
@pytest.mark.parametrize('case', ['scan layout', 'sparse beside full',
                                  'dense', 'gate ties', 'duplicate keys',
                                  'all padding', 'one row', 'ragged',
                                  'int32 edge'])
def test_cell_join_cases(dev, monkeypatch, case, block):
    """K3 equal to its plain version at every block size: the cells of a
    room scan (three groups folded into x, d1*d2 in the thousands, so a
    dx = +-1 offset's bracket spans thousands of rows), a sparse slab
    beside a full one, dense 3x3x3 neighbourhoods, centroid distances
    exactly at r^2 and one ulp either side, duplicate keys (brackets that
    the keys at their ends refuse: the whole table is searched, as the
    census counts), an all-padding table, m = 1, m not a multiple of the
    block, and keys at the int32 ends (wrapped sums, searched over the
    whole table)."""
    monkeypatch.setattr(jk, '_K3_BLOCK', block)
    keys, cen, cc, dims, radius = _cell_input(case)
    args = [torch.from_numpy(a).to(dev) for a in (keys, cen, cc, dims)]
    stats = torch.zeros(2, dtype=torch.int32, device=dev)
    got = jk.cell_neighbor_join(*args, offsets(1), radius, stats=stats)
    want = jk.cell_neighbor_join_plain(*args, offsets(1), radius)
    assert torch.equal(got, want)
    hits = int((jk.cell_neighbor_join_plain(
        *args, offsets(1), float('inf')) >= 0).sum())
    gated = int((want >= 0).sum())
    widest, whole = (int(v) for v in stats.cpu())
    d1d2 = int(dims[1]) * int(dims[2])
    if case == 'scan layout':
        assert hits > keys.shape[0] and 0 < gated < hits
        assert whole == 0 and d1d2 - int(dims[2]) - 2 <= widest <= d1d2 + int(
            dims[2]) + 1
    if case == 'sparse beside full':
        assert whole == 0 and widest > 2048 and gated > 0
    if case in ('dense', 'gate ties'):
        assert whole == 0 and 0 < gated < hits
    if case == 'duplicate keys':
        assert whole > 0 and gated > 0
    if case == 'gate ties':   # exact ties are let in
        c = cen.astype(np.float32)
        pairs = want.cpu().numpy()
        r, i = np.nonzero(pairs >= 0)
        dd = ((c[i] - c[pairs[r, i]]) ** 2).sum(1, dtype=np.float32)
        assert (dd == np.float32(radius) ** 2).sum() > 100
    if case in ('all padding', 'one row'):
        assert hits == 0 and whole == 0
    if case == 'ragged':
        assert keys.shape[0] % block != 0 and gated > 0
    if case == 'int32 edge':
        assert hits > 0 and whole > 0


def _cell_input64(case: str):
    """(keys, centroid, ccoord, dims, radius) of one K3 card case on int64
    keys (int64 max padded): the int32 cases' cells widened, 13 groups of
    blocks of cells on an 80 m x 80 m x 4 m grid at 0.04 m (keys past
    2^31), a grid whose d1 * d2 passes 2^31 (dx = +-1 brackets of
    2^32 rows, clamped to the table), and SemanticKITTI's outdoor grid (8
    thing groups, 1600 x 1600 x 40 cells of 0.05 m at radius 0.1: brackets
    of d1 * d2 = 64000 rows; ground patches two cells thick beside blocks
    of things)."""
    radius = 0.04
    if case == 'outdoor':
        return _outdoor_cells()
    if case in ('scan layout', 'duplicate keys', 'all padding'):
        keys, cen, cc, dims, radius = _cell_input(case)
        k = keys.astype(np.int64)
        k[keys == INT_MAX] = np.iinfo(np.int64).max
        return k, cen, cc, dims, radius
    rng = np.random.RandomState(len(case))
    d = (np.array([2002, 2002, 102]) if case == 'past int32'
         else np.array([40, 70000, 70000]))
    blocks = []
    for _ in range(300):   # 5^3 blocks of cells, 13 groups folded into x
        g = rng.randint(13)
        lo = rng.randint(0, d - 5)
        cube = np.stack(np.meshgrid(*[np.arange(5)] * 3, indexing='ij'),
                        -1).reshape(-1, 3) + lo
        cube = cube[rng.rand(len(cube)) < 0.7]
        blocks.append(np.concatenate([np.full((len(cube), 1), g), cube], 1))
    gc = np.unique(np.concatenate(blocks), axis=0)
    key = ((gc[:, 0] * d[0] + gc[:, 1]) * d[1] + gc[:, 2]) * d[2] + gc[:, 3]
    order = np.argsort(key)
    key, cc = key[order], gc[order, 1:]
    cen = ((cc + 0.5 + 0.6 * (rng.rand(*cc.shape) - 0.5))
           * 0.04).astype(np.float32)
    m = len(key) + 1001
    keys = np.full(m, np.iinfo(np.int64).max, np.int64)
    keys[:len(key)] = key
    ccoord = np.zeros((m, 3), np.int32)
    ccoord[:len(key)] = cc
    centroid = np.zeros((m, 3), np.float32)
    centroid[:len(key)] = cen
    return keys, centroid, ccoord, d.astype(np.int32), radius


def _outdoor_cells():
    """The 'outdoor' case of ``_cell_input64``."""
    rng = np.random.RandomState(9)
    d = np.array([1600, 1600, 40])
    parts = []
    for _ in range(400):
        g = rng.randint(8)
        if rng.rand() < 0.3:   # a ground patch, two cells thick
            lo = np.r_[rng.randint(0, d[:2] - 40), 0]
            size = (40, 40, 2)
        else:                  # a thing: a block of cells
            lo = rng.randint(0, d - 6)
            size = (6, 6, 6)
        cube = np.stack(np.meshgrid(*[np.arange(n) for n in size],
                                    indexing='ij'), -1).reshape(-1, 3) + lo
        cube = cube[rng.rand(len(cube)) < 0.6]
        parts.append(np.concatenate([np.full((len(cube), 1), g), cube], 1))
    gc = np.unique(np.concatenate(parts), axis=0)
    key = ((gc[:, 0] * d[0] + gc[:, 1]) * d[1] + gc[:, 2]) * d[2] + gc[:, 3]
    order = np.argsort(key)
    key, cc = key[order], gc[order, 1:]
    cen = ((cc + 0.5 + 0.6 * (rng.rand(*cc.shape) - 0.5))
           * 0.05).astype(np.float32)
    m = len(key) + 777
    keys = np.full(m, np.iinfo(np.int64).max, np.int64)
    keys[:len(key)] = key
    ccoord = np.zeros((m, 3), np.int32)
    ccoord[:len(key)] = cc
    centroid = np.zeros((m, 3), np.float32)
    centroid[:len(key)] = cen
    return keys, centroid, ccoord, d.astype(np.int32), 0.1


@pytest.mark.parametrize('block', [32, 64, 256])
@pytest.mark.parametrize('case', ['scan layout', 'past int32',
                                  'd1 d2 past int32', 'duplicate keys',
                                  'all padding', 'outdoor'])
def test_cell_join_int64(dev, monkeypatch, case, block):
    """K3 on int64 keys (``sg_cell_join64``) equal to its plain version:
    the room scan's cells widened (equal to the int32 kernel's result too),
    keys past 2^31 in 13 groups, a grid whose d1 * d2 passes 2^31,
    duplicate keys (searched over the whole table), an all-padding table
    and SemanticKITTI's outdoor grid; the launch is counted as an int64
    one."""
    monkeypatch.setattr(jk, '_K3_BLOCK', block)
    keys, cen, cc, dims, radius = _cell_input64(case)
    args = [torch.from_numpy(a).to(dev) for a in (keys, cen, cc, dims)]
    stats = torch.zeros(2, dtype=torch.int32, device=dev)
    n64 = jk.cell_neighbor_join.launches64
    got = jk.cell_neighbor_join(*args, offsets(1), radius, stats=stats)
    assert jk.cell_neighbor_join.launches64 == n64 + 1
    want = jk.cell_neighbor_join_plain(*args, offsets(1), radius)
    assert got.dtype == torch.int32 and torch.equal(got, want)
    gated = int((want >= 0).sum())
    widest, whole = (int(v) for v in stats.cpu())
    if case == 'scan layout':
        k32, *rest = _cell_input(case)
        a32 = [torch.from_numpy(a).to(dev) for a in (k32, *rest[:3])]
        assert torch.equal(got, jk.cell_neighbor_join(*a32, offsets(1),
                                                      radius))
    if case == 'all padding':
        assert gated == 0 and whole == 0
    elif case == 'duplicate keys':
        assert gated > 0 and whole > 0
    else:
        assert gated > 0 and whole == 0
    if case in ('past int32', 'd1 d2 past int32'):
        assert int(keys[keys < np.iinfo(np.int64).max].max()) > 2 ** 31
    if case == 'd1 d2 past int32':
        assert int(dims[1]) * int(dims[2]) > 2 ** 31


@pytest.mark.parametrize('offs_kind', ['reach 2', 'shuffled', 'one offset',
                                       'repeated'])
def test_cell_join_offset_sets(dev, offs_kind):
    """K3 equal to its plain version on the room scan's cells for other
    offset sets than the main path's: the 124 offsets of reach 2 (25 runs
    of up to 5), the 26 in a seeded random order (runs cut where dz falls,
    queries that do not rise), one offset, and offsets repeated."""
    keys, cen, cc, dims, radius = _cell_input('scan layout')
    args = [torch.from_numpy(a).to(dev) for a in (keys, cen, cc, dims)]
    rng = np.random.RandomState(3)
    offs = {'reach 2': offsets(2),
            'shuffled': offsets(1)[rng.permutation(26)],
            'one offset': np.array([[1, -1, 0]], np.int32),
            'repeated': np.concatenate([offsets(1)[:5]] * 3)}[offs_kind]
    got = jk.cell_neighbor_join(*args, offs, 2 * radius)
    want = jk.cell_neighbor_join_plain(*args, offs, 2 * radius)
    assert got.shape == (len(offs), keys.shape[0])
    assert torch.equal(got, want) and int((want >= 0).sum()) > 0


@pytest.mark.parametrize('strided', [False, True])
def test_keyed_conv(dev, strided):
    d = 10
    fine = torch.unique(torch.randint(0, 8 * d ** 3, (3000,), device=dev))
    keys = torch.full((4096,), INT_MAX, dtype=torch.int32, device=dev)
    keys[:fine.shape[0]] = fine.int()
    feats = torch.randn(4096, 32, device=dev).bfloat16()
    if strided:
        b, r = fine // d ** 3, fine % d ** 3
        x, y, z = r // d ** 2, (r // d) % d, r % d
        h = d // 2
        coarse = torch.unique(((b * h + x // 2) * h + y // 2) * h + z // 2)
        out_keys = torch.full((2048,), INT_MAX, dtype=torch.int32,
                              device=dev)
        out_keys[:coarse.shape[0]] = coarse.int()
        w, dd = torch.randn(8, 32, 64, device=dev) * 0.1, h
    else:
        out_keys, w, dd = keys, torch.randn(27, 32, 64, device=dev) * 0.1, d
    got = ck.keyed_conv(feats, w, out_keys, keys, dd, strided).double()
    want = ck.keyed_conv_plain(feats, w, out_keys, keys, dd,
                               strided).double()
    assert float((got - want).abs().max()) <= \
        2.0 ** -7 * max(1.0, float(want.abs().max()))


def _grid_keys(d: int, n: int, seed: int) -> np.ndarray:
    """``n`` sorted unique keys ((b*D + x)*D + y)*D + z of two batches on a
    D-grid, every voxel of the grid's six faces of batch 0 among them."""
    rng = np.random.RandomState(seed)
    c = np.arange(d)
    x, y, z = np.meshgrid(c, c, c, indexing='ij')
    face = ((x == 0) | (x == d - 1) | (y == 0) | (y == d - 1) | (z == 0)
            | (z == d - 1)).ravel()
    keys = np.flatnonzero(face)
    more = rng.randint(0, 2 * d ** 3, 4 * n)
    keys = np.unique(np.concatenate([keys, more]))
    return np.sort(rng.choice(keys, n, replace=False)).astype(np.int32)


@pytest.mark.parametrize('case', ['subm faces', 'subm negative keys',
                                  'subm two tables', 'subm cin 6',
                                  'subm few tiles', 'down',
                                  'down few tiles'])
def test_keyed_conv_cases(dev, case):
    """K4 (K1's kernel with the keyed prologue) against its plain version:
    subm on the D=20 grid with every face voxel present (neighbours off the
    grid), INT_MAX padding, negative keys (no voxel) at the table's head,
    two distinct but equal key tables (the search over the whole table),
    Cin = 6, and few tiles (a tile's steps cut over several blocks)."""
    few = 'few tiles' in case
    d = 20 if case.startswith('subm') else 10
    n = 150 if few else 3000
    fine = _grid_keys(20, n, seed=len(case))
    cap = 256 if few else 4096
    keys = np.full(cap, INT_MAX, np.int32)
    keys[:len(fine)] = fine
    if case == 'subm negative keys':
        keys[:5] = -np.arange(5, 0, -1, dtype=np.int32) * 7
        keys = np.sort(keys)
    cin = 6 if case == 'subm cin 6' else 32
    g = torch.Generator(device=dev).manual_seed(len(case) + 1)
    feats = torch.randn(cap, cin, device=dev, generator=g).bfloat16()
    in_keys = torch.from_numpy(keys).to(dev)
    if case.startswith('down'):
        b, r = fine // 20 ** 3, fine % 20 ** 3
        x, y, zz = r // 400, (r // 20) % 20, r % 20
        coarse = np.unique(((b * d + x // 2) * d + y // 2) * d + zz // 2)
        ok = np.full(cap, INT_MAX, np.int32)
        ok[:len(coarse)] = coarse
        out_keys, k, cout = torch.from_numpy(ok).to(dev), 8, 64
    else:
        out_keys, k, cout = in_keys, 27, 32
        if case == 'subm two tables':
            in_keys = in_keys.clone()
    w = (torch.randn(k, cin, cout, device=dev, generator=g) * 0.1).bfloat16()
    strided = case.startswith('down')
    got = ck.keyed_conv(feats, w, out_keys, in_keys, d, strided).double()
    want = ck.keyed_conv_plain(feats, w, out_keys, in_keys, d,
                               strided).double()
    assert got.shape == (out_keys.shape[0], cout)
    assert float((got - want).abs().max()) <= \
        2.0 ** -7 * max(1.0, float(want.abs().max()))
    rules = ck.rules_from_keys(out_keys, in_keys, d, strided)
    assert int((rules >= 0).sum()) >= n - 5
    if few:   # a tile's steps cut over several blocks
        assert ck._conv_split(k, cin, out_keys.shape[0], cout,
                              torch.bfloat16) > 1


def _conv_dw_case(dev, dtype, k, cin, cout, v_in, v_out, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    f = torch.randn(v_in, cin, device=dev, generator=g).to(dtype)
    go = torch.randn(v_out, cout, device=dev, generator=g).to(dtype)
    r = torch.randint(-v_in, v_in, (k, v_out), device=dev, generator=g).int()
    r[:, v_out // 2:v_out // 2 + 640] = -1    # whole chunks to skip
    return f, go, r


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('k,cin,cout,v_out', [
    (27, 32, 32, 20000), (8, 32, 64, 9000), (27, 384, 192, 3000),
    (27, 6, 32, 5000)], ids=['subm', 'down', 'wide', 'input'])
def test_conv_dw(dev, dtype, k, cin, cout, v_out):
    """K5 against its plain version: f32 sums in another order, relative
    to max|plain| (the inputs are exact in both: bf16 products are exact
    in f32)."""
    f, go, r = _conv_dw_case(dev, dtype, k, cin, cout, 4000, v_out,
                             k + cin + cout)
    got = ck.rulebook_conv_dw(f, go, r).double()
    want = ck.rulebook_conv_dw_plain(f, go, r).double()
    assert got.shape == (k, cin, cout)
    assert float((got - want).abs().max()) <= \
        1e-4 * max(1.0, float(want.abs().max()))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16])
@pytest.mark.parametrize('c', [32, 35, 19])
def test_sorted_segment_sum(dev, dtype, c):
    """K6 against its plain version, with out-of-range rows at both ends
    and a long run on one segment."""
    n, s = 60000, 20000
    seg = torch.randint(-50, s + 50, (n,), device=dev)
    seg[1000:9000] = 777
    seg = torch.sort(seg).values.int()
    vals = torch.randn(n, c, device=dev).to(dtype)
    got = gk.sorted_segment_sum(vals, seg, s).double()
    want = gk.sorted_segment_sum_plain(vals, seg, s).double()
    assert got.shape == (s, c)
    assert float((got - want).abs().max()) <= \
        1e-5 * max(1.0, float(want.abs().max()))


def _segsum_input(case: str, c: int, dtype, dev):
    """(values, seg, num_segments) of one K6 card case; the chunk is
    ``gk.seg_rows_per_chunk`` rows (256 at these widths)."""
    rng = np.random.RandomState(len(case) * 100 + c)
    rows = gk.seg_rows_per_chunk(c * torch.tensor([], dtype=dtype)
                                 .element_size())
    if case == 'span':          # one run over many chunks, short runs around
        n, s = 20 * rows + 77, 5000
        seg = np.sort(rng.randint(0, s, n))
        seg[3 * rows + 5:15 * rows + 9] = seg[3 * rows + 5]
    elif case == 'chunk edge':  # runs that end exactly on chunk edges: one
        n, s = 8 * rows, 3000   # chunk long, two chunks long, half a chunk
        seg = np.repeat(np.arange(0, 8 * 37, 37), rows)
        seg[2 * rows:4 * rows] = 74
        seg[:rows // 2] = 0
        seg[rows // 2:rows] = 1
    elif case == 'gaps':        # empty segments between runs, the first and
        n, s = 9000, 40000      # last rows of out empty
        seg = np.sort(rng.choice(np.arange(5, s - 7), 700, replace=False))
        seg = np.repeat(seg, rng.randint(1, 25, 700))[:n]
        n = len(seg)
    elif case == 'out of range':  # every row below 0 or at or beyond s
        n, s = 3000, 2000
        seg = np.sort(np.concatenate([rng.randint(-40, 0, 1000),
                                      rng.randint(s, s + 50, 2000)]))
    elif case == 'unaligned':   # values 1 element off 16-byte alignment:
        n, s = 5000, 3000       # no 16-byte column vectors, a scalar head
        seg = np.sort(rng.randint(0, s, n))
        vals = torch.from_numpy(rng.randn(n * c + 1).astype(np.float32))
        vals = vals.to(dev).to(dtype)[1:].view(n, c)
        assert vals.data_ptr() % 16 != 0
        return vals, torch.from_numpy(seg.astype(np.int32)).to(dev), s
    elif case == 'no rows':     # an empty input: every row of out zero
        n, s = 0, 300
        seg = np.zeros(0, np.int64)
    elif case == 'small':       # fewer rows than a chunk, not a multiple
        n, s = rows - (59 if rows > 64 else 7), 300   # of anything;
        # out-of-range rows at both ends
        seg = np.sort(rng.randint(-5, s + 5, n))
    else:
        raise ValueError(case)
    vals = torch.from_numpy(rng.randn(n, c).astype(np.float32)).to(dev)
    return (vals.to(dtype), torch.from_numpy(seg.astype(np.int32)).to(dev),
            s)


@pytest.mark.parametrize('dtype,out_dtype', [
    (torch.float32, torch.float32), (torch.bfloat16, torch.float32),
    (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize('c', [19, 32, 35, 300, 301])
@pytest.mark.parametrize('case', ['span', 'chunk edge', 'gaps',
                                  'out of range', 'unaligned', 'small',
                                  'no rows'])
def test_sorted_segment_sum_cases(dev, case, c, dtype, out_dtype):
    """K6 against its plain version: a run over many chunks, runs ending on
    a chunk edge, empty segments between runs with out's first and last
    rows empty, every row out of range, values off 16-byte alignment (no
    16-byte column vectors), fewer rows than a chunk, and no rows at all
    (the zero fill alone).  The path's
    widths (19, 32, 35) and two over 256 columns: 300 (75 f32 column
    vectors a row) and 301 (one strip a chunk, a thread every 256th
    column); over 256 columns a span is finished by one thread a column.
    The kernel writes every row of out itself: the memory handed back for
    out was NaN just before the call.  Two calls are bitwise equal, and the
    bf16 output is the f32 output rounded once."""
    vals, seg, s = _segsum_input(case, c, dtype, dev)
    nan = torch.full((s, c), float('nan'), dtype=out_dtype, device=dev)
    del nan             # the caching allocator hands this block back
    got = gk.sorted_segment_sum(vals, seg, s, out_dtype=out_dtype)
    assert got.dtype == out_dtype and got.shape == (s, c)
    assert torch.equal(got, gk.sorted_segment_sum(vals, seg, s,
                                                  out_dtype=out_dtype))
    want = gk.sorted_segment_sum_plain(vals, seg, s).double()
    scale = max(1.0, float(want.abs().max()))
    err = (got.double() - want).abs()
    if out_dtype == torch.float32:
        assert float(err.max()) <= 1e-5 * scale
    else:   # one bf16 rounding of an f32 sum in another order
        assert bool((err <= 2.0 ** -8 * want.abs() + 1e-5 * scale).all())
        f32 = gk.sorted_segment_sum(vals, seg, s)
        assert torch.equal(got, f32.to(torch.bfloat16))
    if case in ('out of range', 'no rows'):
        assert not got.any()
    if case == 'gaps':
        assert not got[:5].any() and not got[-7:].any()


def test_gather_rows_backward(dev):
    """The differentiable gather on K2 + K6 (sorted and unsorted index)
    against the exact (f64) sum of the cotangent rows: the sorted index's
    last row sums ~1250 rows, where two f32 sums in different orders (an
    f32 index_add_'s atomics) are 1e-4 apart in ~7% of draws."""
    src = torch.randn(3000, 35, device=dev, requires_grad=True)
    for idx, srt in ((torch.randint(0, 3000, (20000,), device=dev), False),
                     (torch.sort(torch.randint(0, 3200, (20000,),
                                               device=dev)).values, True)):
        g = torch.randn(20000, 35, device=dev)
        src.grad = None
        gk.gather_rows(src, idx, sorted_idx=srt).backward(g)
        want = torch.zeros_like(src, dtype=torch.float64).index_add_(
            0, idx.clamp(max=2999), g.double())
        assert float((src.grad.double() - want).abs().max()) <= 1e-4


def test_rules_join_exact(dev):
    rng = np.random.RandomState(1)
    d, m = 20, 8192
    c = np.concatenate([rng.randint(0, 40, (20000, 1)),
                        rng.randint(0, d, (20000, 3))], 1)
    key = np.unique(((c[:, 0] * d + c[:, 1]) * d + c[:, 2]) * d + c[:, 3])
    key = key[:m - 300]
    keys = np.full(m, INT_MAX, np.int32)
    keys[:len(key)] = key
    xyz = np.zeros((m, 3), np.int32)
    xyz[:len(key)] = np.stack([(key // d ** 2) % d, (key // d) % d,
                               key % d], 1)
    args = [torch.from_numpy(a).to(dev) for a in (keys, xyz)]
    dims = torch.tensor([d, d, d], dtype=torch.int32, device=dev)
    offs = offsets(1)
    got = jk.sorted_key_rules_join(*args, dims, offs)
    assert torch.equal(got, jk.sorted_key_rules_join_plain(*args, dims,
                                                           offs))
    assert int((got >= 0).sum()) > 10000


def _rules_input(case: str, dev):
    """(keys, xyz, dims) of one K7 card case: sorted linear keys
    ((b*d0 + x)*d1 + y)*d2 + z, INT_MAX padded."""
    rng = np.random.RandomState(len(case))
    d = (20, 20, 20)
    if case == 'dense grids':      # every row a voxel of full 20^3 grids
        key = np.arange(16 * 8000 + 3072)
    elif case == 'sparse overflow':  # a 16 x 100 x 100 grid 90% full: a
        d = (16, 100, 100)           # tile's window (dlin up to +-10101)
        key = np.sort(rng.choice(160000, 144000, replace=False))
    elif case == 'mixed':          # dense and sparse stretches, padding
        dense = np.arange(4000, 12000)
        sparse = rng.choice(np.arange(20000, 200000), 3000, replace=False)
        key = np.concatenate([dense, np.sort(sparse)])
    elif case == 'duplicate keys':  # the first of equal keys is the match
        key = np.repeat(np.arange(0, 8000, 3), 3)
    elif case == 'all padding':
        key = np.zeros(0, np.int64)
    elif case == 'one row':
        key = np.array([8000 + 421])
    elif case == 'int32 edge':     # queries beyond INT_MAX wrap, as in plain
        key = np.sort(np.concatenate([
            INT_MAX - 1 - rng.choice(5000, 3000, replace=False),
            rng.choice(5000, 2000, replace=False) - 2 ** 31]))
    else:
        raise ValueError(case)
    pad = {'dense grids': 0, 'all padding': 4099, 'one row': 0}.get(case,
                                                                    1001)
    keys = np.concatenate([key, np.full(pad, INT_MAX)]).astype(np.int64)
    vol = d[0] * d[1] * d[2]
    r = np.where(keys == INT_MAX, 0, keys) % vol
    xyz = np.stack([r // (d[1] * d[2]), (r // d[2]) % d[1], r % d[2]], 1)
    return (torch.from_numpy(keys.astype(np.int32)).to(dev),
            torch.from_numpy(xyz.astype(np.int32)).to(dev),
            torch.tensor(d, dtype=torch.int32, device=dev))


@pytest.mark.parametrize('tile', [32, 64, 128, 256])
@pytest.mark.parametrize('case', ['dense grids', 'sparse overflow', 'mixed',
                                  'duplicate keys', 'all padding', 'one row',
                                  'int32 edge'])
def test_rules_join_cases(dev, monkeypatch, case, tile):
    """K7 equal to its plain version at every tile size: full 20^3 grids
    (a trained model's fill), windows longer than the staged part (the
    rest searched in the table: the census counts them), dense and sparse
    stretches with m not a multiple of the tile, duplicate keys (the
    index window does not hold the query range: the searched one does), an
    all-padding table, m = 1, and keys at the int32 ends."""
    monkeypatch.setattr(jk, '_K7_TILE', tile)
    keys, xyz, dims = _rules_input(case, dev)
    offs = np.delete(np.stack(np.meshgrid(*[np.arange(-1, 2)] * 3,
                                          indexing='ij'), -1).reshape(-1, 3),
                     13, axis=0)
    stats = torch.zeros(2, dtype=torch.int32, device=dev)
    got = jk.sorted_key_rules_join(keys, xyz, dims, offs, stats=stats)
    want = jk.sorted_key_rules_join_plain(keys, xyz, dims, offs)
    assert torch.equal(got, want)
    hits = int((want >= 0).sum())
    window, searched = (int(v) for v in stats.cpu())
    if case == 'dense grids':
        assert hits > 20 * keys.shape[0] and window <= tile + 842
        assert searched == 0
    if case == 'sparse overflow':
        assert window > 4096 and searched > 0 and hits > 0
    if case in ('all padding', 'one row'):
        assert hits == 0 and searched == 0
    if case == 'mixed':
        assert keys.shape[0] % tile != 0 and hits > 0


def _dw_rules(dev, k, v_in, v_out, seed):
    """(K, V_out) rules with a quarter of the rows hitting each tap, whole
    32-row steps that all miss and 96 rows that all hit."""
    g = torch.Generator(device=dev).manual_seed(seed)
    r = torch.randint(-3 * v_in, v_in, (k, v_out), device=dev,
                      generator=g).int()
    r = torch.where(r < 0, -1, r)
    r[:, v_out // 2:v_out // 2 + 320] = -1
    r[:, 64:160] = torch.randint(0, v_in, (k, 96), device=dev, generator=g,
                                 dtype=torch.int32)
    return r


@pytest.mark.parametrize('group', [1, 3, 9])
@pytest.mark.parametrize('fill', [1, 4096], ids=['split1', 'split'])
@pytest.mark.parametrize('k,cin,cout,v_out', [
    (8, 32, 64, 6000), (27, 6, 32, 5003), (27, 19, 35, 4001),
    (27, 35, 19, 4004), (27, 64, 64, 6000), (27, 96, 96, 5003),
    (8, 96, 128, 3000), (27, 384, 192, 2048)])
def test_conv_dw_groups(dev, monkeypatch, group, fill, k, cin, cout, v_out):
    """K5 bf16 against its plain version with every shape's tap group set
    to 1, 3 and 9 (groups that do not divide K = 8 or 27), one block per
    (tile, group) or the rows cut over several; widths on the 16-byte,
    4-byte and 2-byte copy paths and ragged tiles; V_out not a multiple of
    the 32-row step, and not of 4 (the rules' 4-byte path).  Two calls are
    bitwise equal."""
    monkeypatch.setattr(ck, '_DW_GROUP', group)
    monkeypatch.setattr(ck, '_DW_FEW_STEPS', 0)
    monkeypatch.setattr(ck, '_DW_FILL_BLOCKS', fill)
    monkeypatch.setattr(ck, '_DW_WIDE_FILL_BLOCKS', fill)
    g = torch.Generator(device=dev).manual_seed(k + cin + cout)
    f = torch.randn(3000, cin, device=dev, generator=g).bfloat16()
    go = torch.randn(v_out, cout, device=dev, generator=g).bfloat16()
    r = _dw_rules(dev, k, 3000, v_out, cin * cout)
    got = ck.rulebook_conv_dw(f, go, r)
    assert torch.equal(got, ck.rulebook_conv_dw(f, go, r))
    want = ck.rulebook_conv_dw_plain(f, go, r).double()
    assert got.shape == (k, cin, cout)
    assert float((got.double() - want).abs().max()) <= \
        1e-4 * max(1.0, float(want.abs().max()))
    split = ck._dw_plan(k, v_out, cin, cout)[1]
    assert (split == 1) == (fill == 1)


def test_conv_dw_tiny_unet_shape(dev):
    """K5 at the training refinement U-Net's shape (27, 131072) 32->32,
    with the capacity's padded tail all -1; bitwise equal across calls."""
    v_in, v_out = 100000, 131072
    g = torch.Generator(device=dev).manual_seed(5)
    f = torch.randn(v_in, 32, device=dev, generator=g).bfloat16()
    go = torch.randn(v_out, 32, device=dev, generator=g).bfloat16()
    r = _dw_rules(dev, 27, v_in, v_out, 6)
    r[:, v_in:] = -1
    got = ck.rulebook_conv_dw(f, go, r)
    assert torch.equal(got, ck.rulebook_conv_dw(f, go, r))
    want = ck.rulebook_conv_dw_plain(f, go, r).double()
    assert float((got.double() - want).abs().max()) <= \
        1e-4 * max(1.0, float(want.abs().max()))


def test_plus_request_matches_cpu(dev):
    """A SoftGroup++ request (``run_scene`` over ``test_forward_plus``: K1,
    K2, K3 and K4 with scene-pyramid grouping at level 3) of the tiny
    config on the card in f32 against the same request on the CPU (plain
    versions): the smoke's gates, offsets within 1e-3 and each CPU
    instance's best IoU with a card instance of its label >= 0.99 on
    average."""
    from softgroup_tpu_torch.model.softgroup import Capacities, SoftGroupNet
    from softgroup_tpu_torch.tools_impl.test_runner import InferenceRunner
    from softgroup_tpu_torch.util.rle import rle_decode
    from torch_helpers import CAPS, PLUS, tiny_cfg, tiny_data

    cfg = tiny_cfg(PLUS)
    data = tiny_data()
    data['scan_ids'] = ['tiny']
    res = {}
    for d in ('cpu', dev):
        net = SoftGroupNet(channels=8, num_blocks=3, semantic_classes=6,
                           instance_classes=4, bf16=False,
                           generator=torch.Generator().manual_seed(3))
        runner = InferenceRunner(net.to(d).eval(), cfg, Capacities(**CAPS),
                                 3, device=d)
        res[d] = runner.run_scene(data)
    a, r = res[dev], res['cpu']
    assert (a['semantic_preds'] == r['semantic_preds']).mean() >= 0.999
    assert np.abs(a['offset_preds'] - r['offset_preds']).max() <= 1e-3
    assert len(r['pred_instances']) > 0
    best = []
    for x in r['pred_instances']:
        mx = rle_decode(x['pred_mask']).astype(bool)
        best.append(max((
            (mx & my).sum() / (mx | my).sum() for my in (
                rle_decode(y['pred_mask']).astype(bool)
                for y in a['pred_instances']
                if y['label_id'] == x['label_id'])), default=0.0))
    assert np.mean(best) >= 0.99


# masked batch norm + ReLU (csrc/norm.cu): the ScanNet train levels (V, C)
# from 524288 x 32 to 8192 x 224, the S3DIS / point-head cap 1048576 x 32,
# the 2C tail of the 192-wide level, STPLS3D's 16 channels, a ragged V and
# a C that takes no 16-byte vectors
BN_SHAPES = [(524288, 32), (262144, 64), (131072, 96), (65536, 128),
             (32768, 160), (16384, 192), (8192, 224), (1048576, 32),
             (16384, 384), (524288, 16), (3001, 32), (5000, 19)]


def _bn_compare(got, want, case, training, relu, dtype):
    """Kernel against autograd of the module's formula on the card, within
    ``time_kernels.bn_faults``'s bounds."""
    faults = bn_faults(got, want, case, training, relu, dtype)
    assert not faults, faults


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('v,c', BN_SHAPES)
def test_batch_norm_train(dev, v, c, dtype):
    """Train mode with the ReLU (every call site's), forward and backward:
    the kernels against autograd of ``batch_norm_plain``; a second call is
    equal bit for bit (no atomics); 3 launches forward, 3 backward."""
    case = bn_case(dev, v, c, dtype, seed=v + c)
    want = bn_run(nk.batch_norm_plain, *case, True, True)
    before = nk.masked_batch_norm.launches
    got = bn_run(nk.masked_batch_norm, *case, True, True)
    assert nk.masked_batch_norm.launches - before == 6
    _bn_compare(got, want, case, True, True, dtype)
    again = bn_run(nk.masked_batch_norm, *case, True, True)
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('case_name', ['no relu', 'one valid', 'none valid',
                                       'all valid', 'unaligned'])
def test_batch_norm_train_cases(dev, case_name, dtype):
    """Without the ReLU; masks with one, none or every row valid; x at an
    address off 16 bytes (one channel a thread)."""
    v, c = 20000, 64
    rows = torch.arange(v, device=dev)
    mask = {'one valid': rows == 123, 'none valid': rows < 0,
            'all valid': rows >= 0}.get(case_name)
    case = list(bn_case(dev, v, c, dtype, seed=7, mask=mask))
    if case_name == 'unaligned':
        base = torch.empty(v * c + 1, dtype=dtype, device=dev)
        base[1:].copy_(case[0].reshape(-1))
        case[0] = base[1:].view(v, c)
        assert nk._tile(case[0])[3] == 1
    relu = case_name != 'no relu'
    want = bn_run(nk.batch_norm_plain, *case, True, relu)
    got = bn_run(nk.masked_batch_norm, *case, True, relu)
    _bn_compare(got, want, case, True, relu, dtype)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32])
@pytest.mark.parametrize('v,c', [(1048576, 32), (8192, 224), (16384, 384),
                                 (5000, 19)])
def test_batch_norm_eval(dev, v, c, dtype):
    """Eval mode: one pass forward with the running statistics, which stay
    as they were; the backward with the parameters (reduction + dx) and
    with x alone (one pass); no-grad calls launch one kernel."""
    case = bn_case(dev, v, c, dtype, seed=3)
    x, mask, scale, bias, mean, var, dy = case
    want = bn_run(nk.batch_norm_plain, *case, False, True)
    got = bn_run(nk.masked_batch_norm, *case, False, True)
    _bn_compare(got, want, case, False, True, dtype)
    assert torch.equal(got[1], mean) and torch.equal(got[2], var)
    xg = x.clone().requires_grad_(True)
    before = nk.masked_batch_norm.launches
    out = nk.masked_batch_norm(xg, None, scale, bias, mean, var, False,
                               BN_EPS, BN_MOMENTUM, True)
    (dx,) = torch.autograd.grad(out, (xg,), dy)
    assert nk.masked_batch_norm.launches - before == 2
    assert torch.equal(dx, got[3])
    with torch.inference_mode():
        before = nk.masked_batch_norm.launches
        y = nk.masked_batch_norm(x, None, scale, bias, mean, var, False,
                                 BN_EPS, BN_MOMENTUM, True)
        assert nk.masked_batch_norm.launches - before == 1
    assert torch.equal(y, got[0])


def test_batch_norm_only_its_kernels(dev):
    """A module call with its backward runs the six norm.cu kernels and no
    PyTorch reduction, elementwise or copy kernel."""
    from torch.profiler import ProfilerActivity, profile

    from softgroup_tpu_torch.model.blocks import MaskedBatchNorm
    from softgroup_tpu_torch.time_kernels import kernel_rows
    x, mask, *_, dy = bn_case(dev, 262144, 64, torch.bfloat16, seed=9)
    bn = MaskedBatchNorm(64).to(dev).train()
    x.requires_grad_(True)
    bn(x, mask, relu=True)     # warm: the library is loaded
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = bn(x, mask, relu=True)
        torch.autograd.grad(out, (x, bn.scale, bn.bias), dy)
        torch.cuda.synchronize()
    names = [name for _, count, name in kernel_rows(prof)
             for _ in range(count)]
    assert len(names) == 6, names
    assert all('bn_' in n for n in names), names
