"""Hold the radius-search kernel's tables against another checkout's, bit for bit.

    python ref_geotransformer_tpu_torch/tools/radius_tables.py dump TABLES.pt
    python ref_geotransformer_tpu_torch/tools/radius_tables.py compare TABLES.pt --checkout DIR

`dump` runs `chip_smoke.py`'s phase 15 on the card (the pyramids' search
groups of 3DMatch at demo and full caps, KITTI, LineMod, a probe (i) pair
and seeded ragged clouds, each held to the plain version up to ties) and
saves every group it checked: each search's inputs and the table this
checkout's kernel gave. `compare` runs each saved search through DIR's
`models.cuda_kernels.radius_search`, one call a search (DIR is a checkout of
this repo, say an earlier commit unpacked with `git archive`, whose kernels
it builds), and prints, for each group, the searches whose tables differ
and the rows that differ in each. For those rows it tells what kind the
difference is, from the kernel's squared distances recomputed on the host
bit for bit (`kernel_d2`): whether the two rows hold the same distance at
every slot (so they differ only in which index they list among equal
distances), and how many of each checkout's rows are in (d^2, index) order.
It exits with 1 if any table differs. Run it as a file, so that `compare`
imports DIR's package, not this one.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _card() -> str:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def fma32(a, b, c):
    """fmaf(a, b, c) over f32 arrays, rounded once to f32 as the card does:
    a * b is exact in f64, and the f64 sum's error (TwoSum) settles the one
    case in which rounding twice differs, a sum exactly halfway between two
    f32 values."""
    a, b, c = (np.asarray(x, np.float32).astype(np.float64) for x in (a, b, c))
    p = a * b
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)
    r = s.astype(np.float32)
    r64 = r.astype(np.float64)
    side = np.nextafter(r, np.where(s > r64, np.float32(np.inf), np.float32(-np.inf))).astype(np.float64)
    halfway = (s != r64) & (s == (r64 + side) / 2) & (err != 0) & ((err > 0) == (s > r64))
    return np.where(halfway, side.astype(np.float32), r)


def kernel_d2(q, s):
    """The radius-search kernel's squared distances (csrc/radius_search.cu,
    its header) between f32 points q (..., 3) and s (..., 3), bit for bit."""
    def norm2(p):
        return fma32(p[..., 2], p[..., 2], fma32(p[..., 0], p[..., 0], fma32(p[..., 1], p[..., 1], 0.0)))

    q, s = np.asarray(q, np.float32), np.asarray(s, np.float32)
    a = np.float32(-2.0) * q
    d = fma32(a[..., 2], s[..., 2], fma32(a[..., 1], s[..., 1], fma32(a[..., 0], s[..., 0], norm2(q))))
    return np.maximum(fma32(1.0, d, norm2(s)), np.float32(0.0))


def tie_report(q, s, ours, theirs):
    """For the rows `ours` and `theirs` (R, limit) of queries q (R, 3) over
    supports s (N, 3), sentinel N: the rows holding the same kernel d^2 at
    every slot, and the rows of each in (d^2, index) order."""
    q, s = np.asarray(q, np.float32), np.asarray(s, np.float32)
    n = len(s)

    def d2(table):
        d = kernel_d2(q[:, None, :], s[np.minimum(table, n - 1)])
        return np.where(table == n, np.float32(np.inf), d)

    do, dt = d2(ours), d2(theirs)

    def ordered(d, t):
        nxt = (d[:, :-1] < d[:, 1:]) | ((d[:, :-1] == d[:, 1:]) & ((t[:, :-1] < t[:, 1:]) | (t[:, 1:] == n)))
        return int(nxt.all(1).sum())

    return int((do == dt).all(1).sum()), ordered(do, ours), ordered(dt, theirs)


def dump(path: str) -> None:
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke

    from ref_geotransformer_tpu_torch.models import cuda_kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    seen = []
    chip_smoke.radius_chain(cuda_kernels, torch.device("cuda:0"), _card(), seen)
    groups = [(label, [tuple(x.cpu() if torch.is_tensor(x) else x for x in search) for search in searches],
               [t.cpu() for t in tables]) for label, searches, tables in seen]
    torch.save(groups, path)
    print(f"[radius_tables] {sum(len(g[1]) for g in groups)} tables of {len(groups)} groups saved to {path}")


def compare(path: str, checkout: str) -> int:
    sys.path.insert(0, os.path.abspath(checkout))
    import torch

    from ref_geotransformer_tpu_torch.models import cuda_kernels

    dev = torch.device("cuda:0")
    card = _card()
    total = differ = 0
    kinds = np.zeros(4, np.int64)  # rows that differ, same d^2 at every slot, ours in order, theirs in order
    for label, searches, tables in torch.load(path):
        rows = []
        for k, (search, table) in enumerate(zip(searches, tables)):
            q, s, qm, sm, radius, limit = search
            got = cuda_kernels.radius_search(q.to(dev), s.to(dev), qm.to(dev), sm.to(dev), radius, limit).cpu()
            if not torch.equal(got, table):
                at = torch.nonzero((got != table).any(1)).flatten()
                report = tie_report(q[at].numpy(), s.numpy(), table[at].numpy(), got[at].numpy())
                kinds += (len(at),) + report
                rows.append(f"search {k} ({q.shape[0]} x {s.shape[0]}, limit {limit}): {len(at)} rows, "
                            f"{report[0]} with the same d^2 at every slot, in (d^2, index) order {report[1]} "
                            f"here and {report[2]} there")
        total += len(searches)
        differ += len(rows)
        print(f"[radius_tables] {card}: {label}: {len(searches) - len(rows)} of {len(searches)} tables "
              f"bit-identical" + (f"; differ: {'; '.join(rows)}" if rows else ""))
    print(f"[radius_tables] {card}: {total - differ} of {total} tables bit-identical to {checkout}'s kernel; "
          f"of the {kinds[0]} rows that differ, {kinds[1]} hold the same d^2 at every slot, {kinds[2]} are in "
          f"(d^2, index) order in the dump and {kinds[3]} in {checkout}'s tables")
    return 1 if differ else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("mode", choices=("dump", "compare"))
    parser.add_argument("tables")
    parser.add_argument("--checkout", help="the checkout whose kernel `compare` runs")
    args = parser.parse_args(argv)
    if args.mode == "dump":
        dump(args.tables)
        return 0
    if not args.checkout:
        parser.error("compare needs --checkout")
    return compare(args.tables, args.checkout)


if __name__ == "__main__":
    sys.exit(main())
