"""The numbers that decide ``correct``, each against its limit.

Training (the first steps of the timed train state against the
reference's three Adam steps, from the same weights on the same rooms):
* ``loss_gap``: the largest |program - reference| / |reference| of a
  step's loss; ``loss_gap1``: the same of step 1 alone (before Adam's
  first update, which moves each weight by about its learning rate
  whichever way rounding tips a gradient near zero, amplifies rounding);
* ``grad_gap_median``: per leaf, |norm(program's step-1 gradient) -
  norm(reference's)| over the larger of the reference leaf's norm and the
  median leaf's, the median over the leaves; the program's gradient is
  read back from Adam's first moment (``exp_avg / (1 - beta1)``).
  ``grad_gap``, the worst leaf's, is reported beside it: the worst leaves
  are batch-norm scales and biases, whose gradients are small residues of
  sums that nearly cancel (a batch norm follows each of them);
* ``change_gap``: the worst leaf's gap of each leaf's change over the
  steps, leaving out the leaves whose reference gradient is under a
  thousandth of the median leaf's (they move by round-off alone, as a
  bias before a batch norm does).

Gaps of norms, not norms of differences: under Adam the direction of a
near-zero gradient is rounding, its size is not.

Serving: ``serve_numbers``.
"""

from __future__ import annotations

import statistics

# the reference's gradient, as a share of the median leaf's, under which a
# leaf's change is left out
ROUNDOFF_SHARE = 1e-3


def _gaps(prog: dict, ref: dict, names) -> dict:
    """Per leaf: |norm(program) - norm(reference)| over the larger of the
    reference leaf's norm and the median leaf's."""
    names = list(names)
    rn = {n: float(ref[n].norm()) for n in names}
    med = statistics.median(rn.values())
    return {n: abs(float(prog[n].norm()) - rn[n]) / max(rn[n], med, 1e-30)
            for n in names}


def train_numbers(prog: dict, ref: dict) -> tuple[dict, dict]:
    """(numbers, notes): ``prog`` / ``ref`` hold ``losses`` (list),
    ``grad`` (step 1) and ``delta`` (the change over the steps), {leaf:
    tensor}."""
    loss_gap = max(abs(p - r) / abs(r)
                   for p, r in zip(prog['losses'], ref['losses']))
    gn = {n: float(g.norm()) for n, g in ref['grad'].items()}
    med = statistics.median(gn.values())
    moved = [n for n, g in gn.items() if g >= ROUNDOFF_SHARE * med]
    g = _gaps(prog['grad'], ref['grad'], gn)
    c = _gaps(prog['delta'], ref['delta'], moved)
    grad_leaf = max(g, key=g.get)
    change_leaf = max(c, key=c.get)
    numbers = dict(
        loss_gap=loss_gap,
        loss_gap1=abs(prog['losses'][0] - ref['losses'][0])
        / abs(ref['losses'][0]),
        grad_gap=g[grad_leaf],
        grad_gap_median=statistics.median(g.values()),
        change_gap=c[change_leaf])
    notes = dict(grad_leaf=grad_leaf, change_leaf=change_leaf,
                 left_out=sorted(set(gn) - set(moved)))
    return numbers, notes


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {value, limit}}): every number at or under its
    limit; a number that is not finite fails."""
    checks = {}
    ok = True
    for name, limit in limits.items():
        value = numbers.get(name)
        good = value is not None and value == value and value <= limit
        ok &= good
        checks[name] = dict(value=value, limit=limit)
    return ok, checks


def _rel(prog, ref, centered: bool = True) -> float:
    """max |program - reference| over the reference's widest departure
    from its column means (``centered``: a random net's point heads sit
    near their biases, and the spread, not the bias, is what the layers
    compute), or over max |reference|."""
    if prog.shape != ref.shape:
        return float('inf')
    if ref.numel() == 0:
        return 0.0
    scale = ((ref - ref.mean(0, keepdim=True)) if centered else ref).abs()
    return float((prog - ref).abs().max() / scale.max().clamp(min=1e-30))


def partition_mismatch(p_pt, p_seg, r_pt, r_seg) -> float:
    """1 - (entries shared by matched proposals) / (the larger side's
    entries).  Proposals are matched greedily by the points they share;
    an entry is (point, proposal), valid entries only."""
    import numpy as np
    import torch
    n_p, n_r = len(p_pt), len(r_pt)
    if n_p == 0 or n_r == 0:
        return 0.0 if n_p == n_r else 1.0
    b = int(r_seg.max()) + 1
    order = torch.argsort(r_pt)
    r_pt_s, r_seg_s = r_pt[order], r_seg[order]
    lo = torch.searchsorted(r_pt_s, p_pt)
    hi = torch.searchsorted(r_pt_s, p_pt, right=True)
    pairs = []
    for j in range(int((hi - lo).max()) if n_p else 0):
        ok = lo + j < hi
        idx = (lo + j).clamp(max=n_r - 1)
        pairs.append((p_seg[ok] * b + r_seg_s[idx][ok]))
    counts = torch.bincount(torch.cat(pairs)) if pairs else \
        torch.zeros(0, dtype=torch.long)
    nz = torch.nonzero(counts).reshape(-1)
    vals = counts[nz].cpu().numpy()
    keys = nz.cpu().numpy()
    used_p, used_r, matched = set(), set(), 0
    for k in np.argsort(-vals, kind='stable'):
        sp, sr = divmod(int(keys[k]), b)
        if sp in used_p or sr in used_r:
            continue
        used_p.add(sp)
        used_r.add(sr)
        matched += int(vals[k])
    return 1.0 - matched / max(n_p, n_r)


def serve_numbers(ref, P: dict, room, host: dict, scale: float, model_cfg,
                  base: dict, prec, device) -> dict:
    """The numbers of one served room (``host``: the program's outputs as
    served, rows in the program's point order), against the reference
    module ``ref`` (``softgroup_serve``):

    * ``semantic_gap`` / ``offset_gap``: the backbone's point heads,
      max |program - reference| over the reference's spread (``_rel``);
    * ``proposal_mismatch``: the program's proposals against the
      reference's grouping of the program's scores and offsets
      (``partition_mismatch``);
    * ``cls_gap`` / ``iou_gap`` / ``mask_gap``: the refinement head on the
      program's proposals: cls and iou (a row a proposal) over max
      |reference|, mask (a row an entry) as the point heads."""
    import torch
    sem_r, off_r, feat_r, coords, order = ref.backbone(
        P, room, scale, model_cfg['num_blocks'], device, prec)
    n = len(order)
    t = lambda a: torch.as_tensor(a, device=device)
    sem_p = t(host['semantic_scores'][:n])
    off_p = t(host['pt_offsets'][:n])
    out = dict(semantic_gap=_rel(sem_p, sem_r[order]),
               offset_gap=_rel(off_p, off_r[order]))
    caps = ref.capacities(n, base)
    coords_s = coords[order]
    # grouping on the program's own scores and offsets (a score a
    # rounding apart moves a point between cells, and a cell between
    # components): the start it skips is judged by the two gaps above
    e_pt, e_seg, e_valid, _ = ref.grouping(sem_p, off_p, coords_s,
                                           model_cfg, caps)
    pv = t(host['entry_valid'])
    out['proposal_mismatch'] = partition_mismatch(
        t(host['entry_pt'])[pv].long(), t(host['entry_seg'])[pv].long(),
        e_pt[e_valid], e_seg[e_valid])
    n_prop_p = int(host['n_proposals'])
    cls_r, iou_r, mask_r = ref.refine(
        P, feat_r[order], coords_s, t(host['entry_pt']).long(),
        t(host['entry_seg']).long(), pv, n_prop_p, caps, model_cfg, prec)
    out['cls_gap'] = _rel(t(host['cls_scores'][:n_prop_p]), cls_r, False)
    out['iou_gap'] = _rel(t(host['iou_scores'][:n_prop_p]), iou_r, False)
    out['mask_gap'] = _rel(t(host['mask_scores'])[pv], mask_r)
    out['n_proposals'] = n_prop_p
    return out
