"""Times of the port's kernels at the main paths' shapes on one card, and
the timing and bound helpers ``chip_smoke.py`` uses.

    python -m softgroup_tpu_torch.time_kernels [label]
        [--cases k1,k2,k3,k4,k5,k6,k7] [--fill N,...] [--dw-group G,...]
        [--dw-fill N,...] [--k6-rows N,...] [--k7-tile T,...]
        [--k3-block N,...]
    PYTHONPATH=<other checkout> python softgroup_tpu_torch/time_kernels.py \\
        [label] [...]

One 250k-point room (seed 0) goes through ``test_forward`` of the seeded
flagship net (bf16, semantic head biased as in ``chip_smoke.py``) while the
K1, K2, K3 and K4 call sites record their arguments; with ``k3``, ``k5``,
``k6`` or ``k7`` in ``--cases``, one all-params train step of the flagship
training config (4 x 250k-point rooms, seeds 200-203) records every K3,
K5, K6 and K7 call.  Each case is then timed and printed as one line
``time_kernels <label> <case> device_ms=... ms=... host_us=...``:
  * device_ms: the kernels' own time a call (the profiler's CUDA time over
    20 calls, divided by 20), without the host's gaps between launches; a
    trace that stays short of 20 x the kernels of one call after three
    tries (the profiler drops kernels now and then) is printed with
    ``partial_trace=True`` and left out of every sum and ranking;
  * ms: CUDA events around 10 back-to-back calls of the wrapper, over 10;
  * host_us: the wrapper's CPU time a call, launch included.
K2's cases add ``library_device_ms`` (``torch.index_select``).  K5 is timed
as a census: one line per distinct shape (K, V_out, Cin, Cout) of the
step's calls with its launches, share of rules that hit, ``device_ms``, the
bound (``dw_bound``) and the error against the plain version, then the
shapes ranked by launches x ``device_ms``.  K4's subm case is timed once
more with two equal key tables (the search over the whole table).
K6 and K7 are timed as censuses too: one line per call of the step (K6:
shape, types, longest run, share of rows in runs longer than a chunk; K7:
m, share of valid keys, largest staged key window, queries searched in the
table beyond it), each with ``device_ms``, bound and error against plain,
plus one synthetic case each at a trained model's fill
(``k6_trained_fill``, ``k7_trained_fill``); ``--k6-rows`` / ``--k7-tile``
re-time them at other rows per K6 chunk / rows per K7 tile.  K3's census
has the request's call (m = 16384) and the train step's (m = 131072), and
each again on int64 keys (the same cells through the 64-bit instance of
the pair-key configs; in a package that has it): m, valid cells, ``dims``, the key windows of each dx group at every tile size, hits
and gated-in queries, the kernel's own bracket figures, device ms, bound
and host us; ``--k3-block`` re-times it at other block sizes.

``--fill`` times the deep K1 cases and K4's at several values of
``conv_kernel._K1_FILL_BLOCKS`` / ``_K4_FILL_BLOCKS`` (the grid size below
which a tile's work is split over several blocks); ``--dw-group`` times the
K5 census with every shape's tap group (``conv_kernel._DW_GROUP``) set to
each value, and ``--dw-fill`` at each value of
``conv_kernel._DW_FILL_BLOCKS`` (and of ``_DW_WIDE_FILL_BLOCKS``). The
second form runs this file's cases on another checkout's package, so two
versions compare on one card in one command, in turns (a, b, b, a); a sweep
applies only where that package has its constant.
"""

from __future__ import annotations

import argparse
import itertools
import time

# the profiler's calls a device time is averaged over
DEVICE_REPS = 20
# card peaks used for the bounds (NVIDIA H100 SXM data sheet, dense)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {'bfloat16': 989e12, 'float32': 67e12}


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bound(byts: float, flops: float, dtype) -> tuple[float, str]:
    """(least ms the card could take, what bounds it)."""
    t_bytes = byts / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[str(dtype).split('.')[-1]]
    return max(t_bytes, t_ops) * 1e3, ('bytes' if t_bytes >= t_ops
                                        else 'operations')


def dw_bound(feats, g, rules) -> tuple[float, str]:
    """K5's bound: one read of feats, g (in feats' type) and the rules, one
    write of the (K, Cin, Cout) f32 result; the FLOPs of the rules that
    hit."""
    k, cin, cout = rules.shape[0], feats.shape[1], g.shape[1]
    hits = int((rules >= 0).sum())
    byts = nbytes(feats, rules) + g.numel() * feats.element_size() \
        + k * cin * cout * 4
    return bound(byts, 2.0 * hits * cin * cout, feats.dtype)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """CUDA events around ``reps`` back-to-back calls, over ``reps``."""
    import torch
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_rows(prof) -> list[tuple[float, int, str]]:
    """(device ms, calls, name) of every kernel, memset and copy that a
    ``torch.profiler`` session saw on the card."""
    from torch.autograd import DeviceType
    rows = []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:   # device activity, no ops
            continue
        us = getattr(ev, 'self_device_time_total', None)
        if us is None:
            us = getattr(ev, 'self_cuda_time_total', 0.0)
        if us > 0:
            rows.append((us / 1e3, ev.count, ev.key))
    return rows


def trace_short(rows, reps: int, per_call: dict) -> list[str]:
    """The kernels that a profile of ``reps`` calls (``rows``, as
    ``kernel_rows`` gives them) saw another number of times than ``reps``
    x their launches in one call (``per_call``: name -> launches), or saw
    though one call launched none: empty when the trace is whole."""
    seen = {name: count for _, count, name in rows}
    return sorted({n for n, k in per_call.items()
                   if seen.get(n, 0) != reps * k} | (seen.keys() - per_call))


def _profile_rows(fn, reps: int) -> list[tuple[float, int, str]]:
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return kernel_rows(prof)


def profiled_rows(fn, reps: int = DEVICE_REPS, tries: int = 3):
    """(``kernel_rows`` of ``reps`` calls of ``fn`` under the profiler,
    whether the trace came up short).  The profiler now and then drops
    kernels from a trace (a whole trace, or a few of its kernels), which
    would read as a fast kernel: each kernel's count is held to ``reps`` x
    its launches in one call (a profile of one call, taken beside it), and
    a short trace is taken again, up to ``tries`` times in all.  The last
    one is returned flagged, to be printed but ranked nowhere."""
    import torch
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        per_call = {name: n for _, n, name in _profile_rows(fn, 1)}
        rows = _profile_rows(fn, reps)
        if per_call and not trace_short(rows, reps, per_call):
            return rows, False
    return rows, True


def device_reading(fn, reps: int = DEVICE_REPS,
                   tries: int = 3) -> tuple[float, bool]:
    """(the card's time of one call of ``fn``: the device time of every
    kernel, memset and copy of ``reps`` calls under the profiler, over
    ``reps``; whether the trace stayed short after ``tries``, see
    ``profiled_rows``)."""
    rows, partial = profiled_rows(fn, reps, tries)
    return sum(r[0] for r in rows) / reps, partial


def reading_text(reading: tuple[float, bool]) -> str:
    """``ms`` of a device reading, with `` partial_trace=True`` when its
    trace came up short."""
    return f'{reading[0]:.6f}' + (' partial_trace=True' if reading[1]
                                  else '')


def device_split(fn, reps: int = DEVICE_REPS) -> str:
    """The device ms a call of each kernel of ``fn`` (profiler, ``reps``
    calls), as ``name:ms,...`` with the names cut at their first '(' (and
    `` partial_trace=True`` for a trace that stayed short)."""
    rows, partial = profiled_rows(fn, reps)
    return ','.join(f'{name.split("(")[0].split("<")[0].split(" ")[-1]}:'
                    f'{ms / reps:.6f}'
                    for ms, _, name in sorted(rows, reverse=True)) + (
        ' partial_trace=True' if partial else '')


def host_us(fn, reps: int = 20) -> float:
    """The host's time of one call of ``fn`` (enqueue, launch included),
    over ``reps`` calls that are not waited for."""
    import torch
    fn()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(reps):
        fn()
    dt = time.perf_counter() - t
    torch.cuda.synchronize()
    return dt / reps * 1e6


class Recorder:
    """Wraps the kernel wrappers at their call sites during one run and
    keeps a clone of the arguments of every call (one clone for a tensor
    passed twice in a call, as K4's subm conv passes its key table)."""

    def __init__(self, sites):
        self.sites = sites          # [(module, attribute name)]
        self.calls: dict[str, list] = {}
        self._saved = []

    def __enter__(self):
        import torch
        for mod, name in self.sites:
            orig = getattr(mod, name)

            def wrapped(*args, _orig=orig, _name=name, **kw):
                clones = {}
                keep = [clones.setdefault(id(a), a.detach().clone())
                        if isinstance(a, torch.Tensor) else a for a in args]
                self.calls.setdefault(_name, []).append((keep, kw))
                return _orig(*args, **kw)
            # a wrapper wrapped in its own module counts its launches on
            # this stand-in (recording runs are not the counted main path)
            wrapped.launches = 0
            self._saved.append((mod, name, orig))
            setattr(mod, name, wrapped)
        return self

    def __exit__(self, *exc):
        for mod, name, orig in self._saved:
            setattr(mod, name, orig)


def pick(calls, pred, what):
    for args, kw in calls:
        if pred(args, kw):
            return args, kw
    raise RuntimeError(f'no recorded call for {what}')


def k1_k2_args(calls: dict, v0: int, cells: int) -> dict:
    """The K1 and K2 cases of ``chip_smoke.py`` and two mid-level K1 convs,
    by label, from the recorded calls of one request (``v0``: level-0
    voxels, ``cells``: the grouping's cell capacity)."""
    import torch
    conv, gather = calls['rulebook_conv'], calls['row_gather']
    return {
        'K1 L0 subm 32->32': pick(conv, lambda a, k: a[2].shape == (27, v0)
                                  and a[1].shape[1:] == (32, 32), 'L0')[0],
        'K1 L1 subm 64->64': pick(
            conv, lambda a, k: a[2].shape[0] == 27
            and a[1].shape[1:] == (64, 64), 'L1')[0],
        'K1 L2 subm 96->96': pick(
            conv, lambda a, k: a[2].shape[0] == 27
            and a[1].shape[1:] == (96, 96), 'L2')[0],
        'K1 input conv 6->32': pick(conv, lambda a, k: a[1].shape[1] == 6,
                                    'input conv')[0],
        'K1 L5 tail 384->192': pick(
            conv, lambda a, k: a[1].shape[1:] == (384, 192), '384')[0],
        'K1 L6 subm 224->224': pick(
            conv, lambda a, k: a[1].shape[1:] == (224, 224), '224')[0],
        'K1 L0->L1 down 32->64': pick(
            conv, lambda a, k: a[2].shape[0] == 8
            and a[1].shape[1:] == (32, 64), 'down')[0],
        'K2 devoxelize (V0, 32) bf16': pick(
            gather, lambda a, k: a[0].dtype == torch.bfloat16
            and a[0].shape == (v0, 32), 'devoxelize')[0],
        'K2 grouping entries (P, 4) f32': pick(
            gather, lambda a, k: a[0].dtype == torch.float32
            and a[0].shape[1:] == (4,), 'entries')[0],
        'K2 cell labels (m+1,) int32': pick(
            gather, lambda a, k: a[0].dim() == 1
            and a[0].shape[0] == cells + 1, 'labels')[0],
    }


def k4_args(calls: list, ch: int = 32) -> dict:
    """K4's two cases (the refinement U-Net's subm conv on the D=20 grid
    and its down conv onto D=10), as (args, kwargs) by label, from the
    recorded ``keyed_conv`` calls of one request of a net ``ch`` wide."""
    return {
        f'K4 subm D=20 {ch}->{ch}': pick(
            calls, lambda a, k: not k['strided'] and a[4] == 20
            and a[1].shape[1:] == (ch, ch), 'keyed subm D=20'),
        f'K4 down D=10 {ch}->{2 * ch}': pick(
            calls, lambda a, k: k['strided'] and a[4] == 10,
            'keyed down D=10'),
    }


def request_args(calls: dict, caps, tag: str,
                 n_heads: int | None = None, cin: int = 6,
                 ch: int = 32) -> dict:
    """The K1, K2 and K4 cases of one request of ``chip_smoke.py`` beyond
    the flagship's, as (args, kwargs) by label (``tag`` after the kernel),
    from its recorded calls (``caps``: its bucketed capacities): the
    backbone's level 0, grouping and refinement.  ``n_heads`` (the
    semantic classes + 3): a SoftGroup++ request, whose heads are gathered
    to the points in one (V0, n_heads) f32 gather and whose grouping
    entries are voxels; None: a request that devoxelizes (V0, 32) bf16
    features and groups points (the S3DIS request, its x4_split parts in
    one level-0 grid, and the SemanticKITTI request).  ``cin``: the
    input conv's channels (1 for SemanticKITTI's remission, 3 for
    STPLS3D's colour); ``ch``: the net's width (16 for STPLS3D)."""
    import torch
    conv, gather = calls['rulebook_conv'], calls['row_gather']
    v0, p, m = caps.voxels[0], caps.grouping_points, caps.grouping_cells
    rows, rname = (v0, 'V0') if n_heads else (caps.points, 'N')
    out = {
        f'K1 {tag} L0 subm {ch}->{ch} bf16 (V0={v0})': pick(
            conv, lambda a, k: a[2].shape == (27, v0)
            and a[1].shape[1:] == (ch, ch), f'{tag} L0 subm'),
        f'K1 {tag} input conv {cin}->{ch} bf16 (V0={v0})': pick(
            conv, lambda a, k: a[1].shape[1] == cin, f'{tag} input conv'),
    }
    if n_heads:
        out[f'K2 {tag} heads (V0, {n_heads}) f32 (V0={v0})'] = pick(
            gather, lambda a, k: a[0].dtype == torch.float32
            and a[0].shape == (v0, n_heads), f'{tag} heads gather')
    else:
        out[f'K2 {tag} devoxelize (V0, {ch}) bf16 (V0={v0})'] = pick(
            gather, lambda a, k: a[0].dtype == torch.bfloat16
            and a[0].shape == (v0, ch), f'{tag} devoxelize')
    out[f'K2 {tag} grouping entries ({rname}, 4) f32 -> P={p}'] = pick(
        gather, lambda a, k: a[0].dtype == torch.float32
        and a[0].shape == (rows, 4) and a[1].shape == (p,),
        f'{tag} entries')
    out[f'K2 {tag} cell labels (m+1,) int32 (m={m})'] = pick(
        gather, lambda a, k: a[0].dim() == 1 and a[0].shape[0] == m + 1,
        f'{tag} labels')
    for label, args in k4_args(calls['keyed_conv'], ch).items():
        out[f'K4 {tag} {label[3:]}'] = args
    return out


def dw_shape_label(shape: tuple, caps, base: int = 32) -> str:
    """``L<level> subm|tail|input|down/up`` of a K5 call of shape (K,
    V_out, Cin, Cout) in a train step with capacities ``caps`` and
    ``base`` channels at level 0 (``tiny L<level>`` for the refinement
    U-Net's levels, whose capacities may equal a backbone level's); a down
    conv and the inverse conv paired with it share a shape."""
    k, v, cin, cout = shape
    where, lvl = f'V={v}', None
    for name, caps_ in (('tiny L', caps.inst_voxels), ('L', caps.voxels)):
        for i, c in enumerate(caps_):
            if c == v and (lvl is None or cout == base * (i + 1)):
                where, lvl = f'{name}{i}', i
    if k == 8:
        return (f'{where[:-1]}{lvl - 1}->{where} down/up' if lvl
                else f'{where} down/up')
    kind = 'input' if cin < 16 else 'tail' if cin == 2 * cout else 'subm'
    return f'{where} {kind}'


def k5_census(calls: list, caps) -> list[dict]:
    """The recorded ``rulebook_conv_dw`` calls of one train step grouped by
    shape (K, V_out, Cin, Cout), in order of first call: each with its
    label, its launches in the step and the arguments of its first call."""
    groups: dict[tuple, dict] = {}
    for args, _ in calls:
        feats, g, rules = args
        shape = (rules.shape[0], rules.shape[1], feats.shape[1], g.shape[1])
        if shape not in groups:
            groups[shape] = dict(shape=shape, args=args, launches=0,
                                 label=dw_shape_label(shape, caps))
        groups[shape]['launches'] += 1
    return list(groups.values())


def k5_args(calls: list, caps) -> dict:
    """The K5 cases of ``chip_smoke.py``, by label, from the recorded
    ``rulebook_conv_dw`` calls of one all-params train step."""
    v0, v1 = caps.voxels[0], caps.voxels[1]

    def shape(k, v, cin, cout):
        return lambda a, kw: (a[2].shape == (k, v) and a[0].shape[1] == cin
                              and a[1].shape[1] == cout)
    return {
        'L0 subm 32->32': pick(calls, shape(27, v0, 32, 32), 'dW L0')[0],
        'L1 subm 64->64': pick(calls, shape(27, v1, 64, 64), 'dW L1')[0],
        'L2 subm 96->96': pick(calls, shape(27, caps.voxels[2], 96, 96),
                               'dW L2')[0],
        'L5 tail 384->192': pick(
            calls, lambda a, k: a[0].shape[1] == 384
            and a[1].shape[1] == 192, 'dW 384->192')[0],
        'L6 subm 224->224': pick(
            calls, lambda a, k: a[0].shape[1] == 224
            and a[1].shape[1] == 224, 'dW 224->224')[0],
        'L0->L1 (8, V1) 32->64': pick(calls, shape(8, v1, 32, 64),
                                      'dW down L0')[0],
        f'tiny U-Net subm {caps.inst_voxels[0]} 32->32': pick(
            calls, shape(27, caps.inst_voxels[0], 32, 32), 'dW tiny')[0],
    }


# a K6 call of the flagship train step, by its width
K6_SITES = {32: 'devoxelize backward', 35: 'proposal-gather backward',
            19: 'mask-gather backward'}


def segsum_bound(values, seg, num_segments, out_dtype=None):
    """K6's bound: one read of values and seg, one write of the
    (num_segments, C) output in ``out_dtype`` (f32 by default)."""
    import torch
    out_elt = torch.empty((), dtype=out_dtype or torch.float32).element_size()
    return bound(nbytes(values, seg) + num_segments * values.shape[1]
                 * out_elt, 0.0, values.dtype)


def rules_bound(keys, xyz, dims, n_off: int):
    """K7's bound: one read of keys, coords and dims, one write of the
    (n_off, m) int32 rulebook."""
    import torch
    return bound(nbytes(keys, xyz, dims) + n_off * keys.shape[0] * 4, 0.0,
                 torch.float32)


def cell_join_bound(keys, centroid, ccoord, dims, n_off: int):
    """K3's bound: one read of keys, centroids, coarse coords and dims, one
    write of the (n_off, m) int32 candidate table."""
    import torch
    return bound(nbytes(keys, centroid, ccoord, dims)
                 + n_off * keys.shape[0] * 4, 0.0, torch.float32)


# the tiles of consecutive cells K3's census counts key windows for
JOIN_TILES = (32, 64, 128, 256)


def key_pad(keys) -> int:
    """The padding key of a K3 table (its type's largest value; int32's in
    a package whose K3 takes int32 keys only)."""
    from softgroup_tpu_torch.ops import join_kernel as jk
    pad = getattr(jk, 'key_sentinel', None)
    return pad(keys) if pad is not None else 2 ** 31 - 1


def widened(args):
    """A recorded K3 call's arguments with its int32 keys as int64 keys
    (int64 max padded): the same cells through the 64-bit instance."""
    import torch
    keys = args[0]
    wide = torch.where(keys == 2 ** 31 - 1, torch.iinfo(torch.int64).max,
                       keys.long())
    return [wide, *args[1:]]


def k3_windows(keys, dims, offs, tile: int) -> list[tuple[int, int, float]]:
    """The key windows a block of ``tile`` consecutive cells would stage
    for K3 (one a dx, as the TPU kernel and K7 stage theirs): for each dx
    of the offsets (ascending), (dx, the largest and the mean count over
    the tiles of the keys in [kmin + dmin, kmax + dmax]), kmin / kmax the
    smallest / largest valid key of a tile and dmin / dmax the smallest /
    largest dlin of the offsets with that dx."""
    import numpy as np
    import torch
    k = keys.long()
    pad = key_pad(keys)
    m = k.shape[0]
    n_t = -(-m // tile)
    kt = torch.cat([k, k.new_full((n_t * tile - m,), pad)]).view(n_t, tile)
    valid = kt != pad
    live = valid[:, 0]
    kmin = kt[:, 0][live]
    kmax = torch.where(valid, kt, -2 ** 62).amax(1)[live]
    d = [int(v) for v in dims.cpu()]
    o = np.asarray(offs, np.int64).reshape(-1, 3)
    dl = (o[:, 0] * d[1] + o[:, 1]) * d[2] + o[:, 2]
    out = []
    for dx in sorted(set(o[:, 0].tolist())):
        sel = dl[o[:, 0] == dx]
        n = (torch.searchsorted(k, kmax + int(sel.max()), right=True)
             - torch.searchsorted(k, kmin + int(sel.min())))
        out.append((dx, int(n.max()) if n.numel() else 0,
                    float(n.double().mean()) if n.numel() else 0.0))
    return out


def k3_census(cases: list, lbl: str, card: str, blocks: list,
              device_only: bool = False, device: str = 'cuda') -> None:
    """Times every recorded K3 call (``cases``: (label, args, launches)):
    one line each with m, the valid cells, ``dims``, each dx group's key
    window (largest and mean over the tiles) at every tile size (what a
    tile a block that stages one window a dx group would stage), the
    queries that hit a key and those the centroid gate lets in; then, at
    each block size of ``blocks`` (None: the package's), the widest bracket
    searched and the queries searched over the whole table (where the
    package's K3 counts them), device ms, bound, host us and whether it
    equals the plain version, and the sum of launches x device ms."""
    import inspect

    import torch

    from softgroup_tpu_torch.ops import join_kernel as jk
    has_stats = 'stats' in inspect.signature(
        jk.cell_neighbor_join).parameters
    has_block = hasattr(jk, '_K3_BLOCK')
    block0 = getattr(jk, '_K3_BLOCK', None)
    for label, a, _ in cases:
        keys, cen, cc, dims, offs, radius = a
        valid = int((keys != key_pad(keys)).sum())
        hits = int((jk.cell_neighbor_join_plain(
            keys, cen, cc, dims, offs, float('inf')) >= 0).sum())
        gated = int((jk.cell_neighbor_join_plain(*a) >= 0).sum())
        wins = ' '.join(
            f'windows_t{t}=' + ','.join(f'dx{dx}:{mx}/{mean:.1f}'
                                        for dx, mx, mean in
                                        k3_windows(keys, dims, offs, t))
            for t in JOIN_TILES)
        print(f'time_kernels {lbl} K3 census {label} m={keys.shape[0]} '
              f'valid_cells={valid} dims={[int(v) for v in dims.cpu()]} '
              f'offsets={len(offs)} hits={hits} gated_in={gated} {wins} '
              f'(windows: dx:largest/mean keys over the tiles)', flush=True)
    for block in blocks:
        if block is not None and not has_block:
            continue
        if block is not None:
            jk._K3_BLOCK = block
        tag = f' block={block}' if block is not None else ''
        total = 0.0
        for label, a, launches in cases:
            keys, cen, cc, dims, offs, radius = a
            want = jk.cell_neighbor_join_plain(*a)
            stats = torch.zeros(2, dtype=torch.int32, device=device)
            got = jk.cell_neighbor_join(
                *a, **({'stats': stats} if has_stats else {}))
            equal = torch.equal(got, want)
            widest, whole = ((int(v) for v in stats.cpu()) if has_stats
                             else ('n/a', 'n/a'))
            b_ms, b_by = cell_join_bound(keys, cen, cc, dims, len(offs))
            dev = _timed(
                lbl, f'K3 census {label}{tag}',
                lambda a_=a: jk.cell_neighbor_join(*a_), card,
                f' launches={launches} widest_bracket={widest} '
                f'whole_table_searches={whole} bound_ms={b_ms:.6f} '
                f'({b_by}) equal={equal}', device_only)
            if not equal:
                raise RuntimeError(f'K3 {label}: differs from plain')
            total += launches * dev
        print(f'time_kernels {lbl} K3 census{tag}: '
              f'{sum(c[2] for c in cases)} launches, sum of launches x '
              f'device_ms = {total:.6f} ms [{card}]', flush=True)
    if has_block:
        jk._K3_BLOCK = block0


def run_lengths(seg, chunk: int) -> tuple[int, float]:
    """(the longest run of a sorted seg, the share of its rows in runs
    longer than ``chunk`` rows)."""
    import torch
    if seg.numel() == 0:
        return 0, 0.0
    _, counts = torch.unique_consecutive(seg, return_counts=True)
    return int(counts.max()), float(counts[counts > chunk].sum()) / seg.numel()


def k6_trained_fill(device, n: int = 524288, c: int = 19,
                    num_segments: int = 131072, seed: int = 0):
    """K6 at a trained model's fill, as the mask-gather backward would see
    it: (n, c) bf16 values in runs of 1-16 rows on a seeded random subset
    of ``num_segments`` segments (no dustbin run).  Returns (values, seg,
    num_segments)."""
    import numpy as np
    import torch
    rng = np.random.RandomState(seed)
    lengths = rng.randint(1, 17, n)
    ends = np.cumsum(lengths)
    k = int(np.searchsorted(ends, n)) + 1
    lengths = lengths[:k].copy()
    lengths[-1] -= ends[k - 1] - n
    seg = np.repeat(np.sort(rng.choice(num_segments, k, replace=False)),
                    lengths).astype(np.int32)
    vals = rng.randn(n, c).astype(np.float32)
    return (torch.from_numpy(vals).to(device).bfloat16(),
            torch.from_numpy(seg).to(device), num_segments)


def k7_trained_fill(device, m: int = 131072, d: int = 20):
    """K7 at a trained model's fill: every row a valid key of dense d^3
    proposal grids (m / d^3 grids, the last one partly filled), with its
    coords, the grid's dims and the 26 non-centre offsets, as
    ``rulebook.build_subm_rules_linear`` passes them."""
    import numpy as np
    import torch

    from softgroup_tpu_torch.ops import rulebook
    keys = np.arange(m, dtype=np.int64)
    r = keys % d ** 3
    xyz = np.stack([r // d ** 2, (r // d) % d, r % d], 1)
    return (torch.from_numpy(keys.astype(np.int32)).to(device),
            torch.from_numpy(xyz.astype(np.int32)).to(device),
            torch.tensor([d, d, d], dtype=torch.int32, device=device),
            rulebook._NON_CENTER)


def k6_census(calls: list, lbl: str, card: str, rows_caps: list,
              device_only: bool = False, device: str = 'cuda') -> None:
    """Times every recorded K6 call of one train step, and the trained-fill
    case: one line each with its shape and types, longest run, share of
    rows in runs longer than a chunk, device ms, bound and error against
    the plain version; the backward's K6 with its cast to the gradient's
    dtype (``tail``); with an ``out_dtype`` argument, the f32 output too.
    Then the sum of launches x device ms over the step's calls."""
    import inspect

    import torch

    from softgroup_tpu_torch.ops import gather_kernel as gk
    has_out = 'out_dtype' in inspect.signature(
        gk.sorted_segment_sum).parameters
    # the cap on the rows per chunk, where the package's K6 reads it
    rows0 = getattr(gk, '_SEG_ROWS', None) \
        if hasattr(gk, 'seg_rows_per_chunk') else None
    cases = [(K6_SITES.get(a[0].shape[1], f'C={a[0].shape[1]}'), a, kw, 1)
             for a, kw in calls]
    syn = k6_trained_fill(device)
    cases.append(('trained fill', syn,
                  {'out_dtype': torch.bfloat16} if has_out else {}, 0))
    for cap in rows_caps:
        if cap is not None and rows0 is None:
            continue   # a constant this package does not have
        if cap is not None:
            gk._SEG_ROWS = cap
        tag = f' rows_cap={cap}' if cap is not None else ''
        total = 0.0
        for label, (vals, seg, s), kw, launches in cases:
            n, c = vals.shape
            chunk = gk.seg_rows_per_chunk(c * vals.element_size()) \
                if hasattr(gk, 'seg_rows_per_chunk') else 256
            longest, share = run_lengths(seg, chunk)
            want = gk.sorted_segment_sum_plain(vals, seg, s).double()
            scale = float(want.abs().max()) or 1.0   # no floor: relative
            runs = [(f'out={str(kw.get("out_dtype", torch.float32))[6:]}',
                     kw)]
            if has_out and kw.get('out_dtype', torch.float32) \
                    != torch.float32:
                runs.append(('out=float32', {}))
            for j, (what, kw_) in enumerate(runs):
                got = gk.sorted_segment_sum(vals, seg, s, **kw_).double()
                rel = float((got - want).abs().max()) / scale
                b_ms, b_by = segsum_bound(vals, seg, s, kw_.get('out_dtype'))
                dev = _timed(
                    lbl, f'K6 census {label} ({n}, {c}) '
                    f'{str(vals.dtype)[6:]} {what}{tag}',
                    lambda v=vals, g=seg, s_=s, k=kw_:
                    gk.sorted_segment_sum(v, g, s_, **k), card,
                    f' launches={launches if j == 0 else 0} segments={s} '
                    f'chunk={chunk} longest_run={longest} '
                    f'rows_in_runs_over_a_chunk={share:.4f} '
                    f'bound_ms={b_ms:.6f} ({b_by}) rel_err={rel:.3g}'
                    + ('' if device == 'cpu' else ' kernels=' + device_split(
                        lambda v=vals, g=seg, s_=s, k=kw_:
                        gk.sorted_segment_sum(v, g, s_, **k))),
                    device_only)
                if j == 0:
                    total += launches * dev
            _timed(lbl, f'K6 census {label} tail (K6 + cast to '
                   f'{str(vals.dtype)[6:]}){tag}',
                   lambda v=vals, g=seg, s_=s, k=kw:
                   gk.sorted_segment_sum(v, g, s_, **k).to(v.dtype), card,
                   device_only=True)
        print(f'time_kernels {lbl} K6 census{tag}: '
              f'{sum(c[3] for c in cases)} launches, sum of launches x '
              f'device_ms = {total:.6f} ms [{card}]', flush=True)
    if rows0 is not None:
        gk._SEG_ROWS = rows0


def k7_census(calls: list, lbl: str, card: str, tiles: list,
              device_only: bool = False, device: str = 'cuda') -> None:
    """Times every recorded K7 call of one train step, and the trained-fill
    case: one line each with m, the share of valid keys, the largest
    staged key window and the queries searched in the table beyond it
    (where the package's K7 counts them), device ms, bound and whether it
    equals the plain version.  Then the sum of launches x device ms."""
    import inspect

    import torch

    from softgroup_tpu_torch.ops import join_kernel as jk
    has_stats = 'stats' in inspect.signature(
        jk.sorted_key_rules_join).parameters
    has_tile = hasattr(jk, '_K7_TILE')
    tile0 = getattr(jk, '_K7_TILE', None)
    cases = [(f'm={a[0].shape[0]}', a, 1) for a, _ in calls]
    cases.append(('trained fill m=131072', k7_trained_fill(device), 0))
    for tile in tiles:
        if tile is not None and not has_tile:
            continue
        if tile is not None:
            jk._K7_TILE = tile
        tag = f' tile={tile}' if tile is not None else ''
        total = 0.0
        for label, a, launches in cases:
            keys, xyz, dims, offs = a
            want = jk.sorted_key_rules_join_plain(*a)
            stats = torch.zeros(2, dtype=torch.int32, device=device)
            got = jk.sorted_key_rules_join(
                *a, **({'stats': stats} if has_stats else {}))
            equal = torch.equal(got, want)
            window, searched = ((int(v) for v in stats.cpu()) if has_stats
                                else ('n/a', 'n/a'))
            valid = float((keys != 2 ** 31 - 1).float().mean())
            b_ms, b_by = rules_bound(keys, xyz, dims, len(offs))
            dev = _timed(
                lbl, f'K7 census {label}{tag}',
                lambda a_=a: jk.sorted_key_rules_join(*a_), card,
                f' launches={launches} valid_keys={valid:.4f} '
                f'largest_window={window} searched_in_table={searched} '
                f'hits={int((want >= 0).sum())} bound_ms={b_ms:.6f} '
                f'({b_by}) equal={equal}'
                + ('' if device == 'cpu' else ' kernels=' + device_split(
                    lambda a_=a: jk.sorted_key_rules_join(*a_))),
                device_only)
            if not equal:
                raise RuntimeError(f'K7 {label}: differs from plain')
            total += launches * dev
        print(f'time_kernels {lbl} K7 census{tag}: '
              f'{sum(c[2] for c in cases)} launches, sum of launches x '
              f'device_ms = {total:.6f} ms [{card}]', flush=True)
    if has_tile:
        jk._K7_TILE = tile0


def _timed(label, name, fn, card, extra='', device_only=False):
    """Prints one timed case; returns its device ms, NaN where the trace
    stayed short (so no sum or ranking takes it)."""
    reading = device_reading(fn)
    more = '' if device_only else \
        f' ms={cuda_ms(fn):.6f} host_us={host_us(fn):.3f}'
    print(f'time_kernels {label} {name} device_ms={reading_text(reading)}'
          f'{more}{extra} [{card}]', flush=True)
    return float('nan') if reading[1] else reading[0]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('label', nargs='?', default='')
    ap.add_argument('--cases', default='k1,k2,k3,k4,k5,k6,k7',
                    help='comma-separated kernel families to time')
    ap.add_argument('--fill', default='',
                    help='comma-separated _K1_FILL_BLOCKS values to time the '
                         'deep K1 cases at')
    ap.add_argument('--dw-group', default='',
                    help='comma-separated K5 tap-group sizes to time the '
                         'census at')
    ap.add_argument('--dw-fill', default='',
                    help='comma-separated _DW_FILL_BLOCKS values to time the '
                         'census at')
    ap.add_argument('--shapes', default='',
                    help='comma-separated labels of the census shapes to '
                         'time (all by default)')
    ap.add_argument('--k6-rows', default='',
                    help='comma-separated caps on K6\'s rows per chunk '
                         '(gather_kernel._SEG_ROWS) to time its census at')
    ap.add_argument('--k7-tile', default='',
                    help='comma-separated K7 tile sizes '
                         '(join_kernel._K7_TILE) to time its census at')
    ap.add_argument('--k3-block', default='',
                    help='comma-separated K3 block sizes '
                         '(join_kernel._K3_BLOCK) to time its census at')
    ap.add_argument('--device-only', action='store_true',
                    help='time the K3, K5, K6 and K7 censuses on device '
                         'time alone')
    args = ap.parse_args()
    families = set(args.cases.split(','))
    import numpy as np
    import torch

    from softgroup_tpu_torch import entry
    from softgroup_tpu_torch.data.synthetic import make_room_scene
    from softgroup_tpu_torch.model import blocks
    from softgroup_tpu_torch.model import softgroup as sg
    from softgroup_tpu_torch.ops import conv_kernel as ck
    from softgroup_tpu_torch.ops import gather_kernel as gk
    from softgroup_tpu_torch.ops import join_kernel as jk
    from softgroup_tpu_torch.ops import (grouping, kernels, rulebook,
                                         sparse_conv)
    if not torch.cuda.is_available():
        raise SystemExit('time_kernels: needs a CUDA card')
    kernels.build_all()
    card = torch.cuda.get_device_name(0)
    lbl = args.label

    def lift(net):
        with torch.no_grad():
            net.semantic_linear.final_bias[2:4] = 2.5
        return net

    k3_cases = []
    if families & {'k1', 'k2', 'k3', 'k4'}:
        cfg, caps = entry.flagship_cfg(), entry.bench_capacities()
        net = lift(entry.build_net(cfg, seed=0, device='cuda'))
        batch = entry.build_batch(make_room_scene(
            np.random.RandomState(0), n_points=250000, n_instances=12),
            cfg, caps)
        sites = [(sparse_conv, 'rulebook_conv'), (gk, 'row_gather'),
                 (grouping, 'row_gather'), (sg, 'row_gather'),
                 (blocks, 'keyed_conv'), (grouping, 'cell_neighbor_join')]
        with Recorder(sites) as rec:
            entry.infer(net, batch, cfg, caps)
            torch.cuda.synchronize()
        k3_cases += [(f'request m={a[0].shape[0]}', a, 1)
                     for a, _ in rec.calls['cell_neighbor_join']]
        cases = k1_k2_args(rec.calls, caps.voxels[0], caps.grouping_cells)
        fills = [int(f) for f in args.fill.split(',') if f] or [None]
        fill0 = ck._K1_FILL_BLOCKS
        for name, a in cases.items():
            if name.startswith('K1') and 'k1' in families:
                feats, w, rules = a[0].bfloat16(), a[1].bfloat16(), a[2]
                deep = feats.shape[1] >= 224
                for fill in (fills if deep else [None]):
                    ck._K1_FILL_BLOCKS = fill0 if fill is None else fill
                    tag = f' fill={fill}' if fill is not None else ''
                    _timed(lbl, f'{name} bf16{tag}',
                           lambda f=feats, w_=w, r=rules:
                           ck.rulebook_conv(f, w_, r), card)
            elif name.startswith('K2') and 'k2' in families:
                src, idx = a
                idx_l = idx.long().clamp(0, src.shape[0] - 1)
                lib = (lambda s=src, i=idx_l: torch.index_select(s, 0, i))
                _timed(lbl, f'{name} idx={idx.dtype}',
                       lambda s=src, i=idx: gk.row_gather(s, i), card,
                       f' library_device_ms={reading_text(device_reading(lib))} '
                       f'library_ms={cuda_ms(lib):.6f}')
        if 'k4' in families:
            k4 = list(k4_args(rec.calls['keyed_conv']).items())
            # the subm conv again with two equal key tables: its searches
            # span the whole table, not the rows within the key offset
            (name, (a, kw)) = k4[0]
            k4.append((f'{name} two tables', ([*a[:3], a[3].clone(), a[4]],
                                              kw)))
            # K4's split target (K1's in a package without its own)
            attr = '_K4_FILL_BLOCKS' if hasattr(ck, '_K4_FILL_BLOCKS') \
                else '_K1_FILL_BLOCKS'
            k4_fill0 = getattr(ck, attr)
            for name, (a, kw) in k4:
                feats, w, ok, ik, d = a
                for fill in fills:
                    setattr(ck, attr, k4_fill0 if fill is None else fill)
                    tag = f' fill={fill}' if fill is not None else ''
                    _timed(lbl, f'{name} bf16{tag}',
                           lambda f=feats, w_=w, o=ok, i=ik, d_=d,
                           s=kw['strided']: ck.keyed_conv(f, w_, o, i, d_,
                                                          s), card)
            setattr(ck, attr, k4_fill0)
        ck._K1_FILL_BLOCKS = fill0
        del rec, cases, net, batch

    def values(opt):
        return [int(x) for x in opt.split(',') if x] or [None]

    train_sites = {'k3': (grouping, 'cell_neighbor_join'),
                   'k5': (sparse_conv, 'rulebook_conv_dw'),
                   'k6': (gk, 'sorted_segment_sum'),
                   'k7': (rulebook, 'sorted_key_rules_join')}
    if families & set(train_sites):
        tcfg, tcaps = entry.train_cfg(), entry.train_capacities()
        scenes = [make_room_scene(np.random.RandomState(200 + j),
                                  n_points=250000, n_instances=12)
                  for j in range(4)]
        tbatch = entry.build_train_batch(scenes, tcfg, tcaps)
        state = entry.build_train_state(
            lift(entry.build_net(tcfg, seed=0, device='cuda')), tcfg, tcaps)
        with Recorder([site for f, site in train_sites.items()
                       if f in families]) as trec:
            state.step(tbatch, generator=torch.Generator().manual_seed(0))
            torch.cuda.synchronize()
        del state, tbatch
        torch.cuda.empty_cache()
        tcalls = trec.calls
        del trec

    if 'k3' in families:
        k3_cases += [(f'train step m={a[0].shape[0]}', a, 1)
                     for a, _ in tcalls['cell_neighbor_join']]
        if hasattr(jk, 'key_sentinel'):   # a package with the int64 K3
            k3_cases += [(f'{label} int64 keys', widened(a), n)
                         for label, a, n in list(k3_cases)]
        k3_census(k3_cases, lbl, card, values(args.k3_block),
                  args.device_only)
    if 'k6' in families:
        k6_census(tcalls['sorted_segment_sum'], lbl, card,
                  values(args.k6_rows), args.device_only)
    if 'k7' in families:
        k7_census(tcalls['sorted_key_rules_join'], lbl, card,
                  values(args.k7_tile), args.device_only)

    if 'k5' in families:
        census = k5_census(tcalls['rulebook_conv_dw'], tcaps)
        if args.shapes:
            census = [c for c in census
                      if c['label'] in args.shapes.split(',')]
        group0 = getattr(ck, '_DW_GROUP', None)
        few0 = getattr(ck, '_DW_FEW_STEPS', None)
        fill0 = getattr(ck, '_DW_FILL_BLOCKS', None)
        wide0 = getattr(ck, '_DW_WIDE_FILL_BLOCKS', None)
        for grp, fill in itertools.product(values(args.dw_group),
                                           values(args.dw_fill)):
            if (grp is not None and group0 is None) or (
                    fill is not None and fill0 is None):
                continue   # a constant this package does not have
            if grp is not None:   # every shape at this group
                ck._DW_GROUP, ck._DW_FEW_STEPS = grp, 0
            if fill is not None:
                ck._DW_FILL_BLOCKS = ck._DW_WIDE_FILL_BLOCKS = fill
            tag = (f' group={grp}' if grp is not None else '') + \
                (f' fill={fill}' if fill is not None else '')
            total = 0.0
            for c in census:
                feats, g, rules = c['args']
                b_ms, b_by = dw_bound(feats, g, rules)
                name = f'K5 census {c["label"]} {c["shape"]}{tag}'
                try:
                    got = ck.rulebook_conv_dw(feats, g, rules).double()
                    want = ck.rulebook_conv_dw_plain(feats, g, rules)
                    rel = float((got - want).abs().max()) / max(
                        1.0, float(want.abs().max()))
                    del got, want
                    hits = float((rules >= 0).float().mean())
                    dev = _timed(
                        lbl, name, lambda f=feats, g_=g, r=rules:
                        ck.rulebook_conv_dw(f, g_, r), card,
                        f' launches={c["launches"]} hits={hits:.4f} '
                        f'bound_ms={b_ms:.6f} ({b_by}) rel_err={rel:.3g}',
                        args.device_only)
                except RuntimeError as e:   # a sweep's setting the
                    # kernel refuses (shared memory): no time
                    print(f'time_kernels {lbl} {name} failed: {e}',
                          flush=True)
                    dev = float('nan')
                c['device_ms'] = dev
                total += dev * c['launches']
            print(f'time_kernels {lbl} K5 census{tag}: '
                  f'{sum(c["launches"] for c in census)} launches, '
                  f'sum of launches x device_ms = {total:.6f} ms '
                  f'[{card}]', flush=True)
            for c in sorted(census, key=lambda c: -c['device_ms']
                            * c['launches']):
                print(f'time_kernels {lbl} K5 rank{tag} {c["label"]} '
                      f'{c["shape"]} launches={c["launches"]} '
                      f'launches_x_device_ms='
                      f'{c["launches"] * c["device_ms"]:.6f}',
                      flush=True)
        if group0 is not None:
            ck._DW_GROUP, ck._DW_FEW_STEPS = group0, few0
        if fill0 is not None:
            ck._DW_FILL_BLOCKS, ck._DW_WIDE_FILL_BLOCKS = fill0, wide0


if __name__ == '__main__':
    main()
