"""Entry points of the port (the twin of the repository's
__graft_entry__.py, which drives the JAX package).

`entry()` returns the engine's flagship computation, the fused compressed
scan (ops/fused_scan.scan_table: bit-unpack, range predicate, sum / count /
min / max; kernel B1 on a CUDA device), with example arguments on the
device.

`dryrun_multichip(n)` runs the distributed query step on an n-shard mesh,
stage for stage as the JAX package's dryrun: SQL on Database(mesh=...)
(the Q6 and Q1 shapes and a PK-FK shuffle join, with dist_stats showing
the distributed paths ran), the segment-parallel scan-aggregate, the
all_to_all group-by, the pre-aggregating combiner, the shuffle join and
top-k, each held against NumPy; a difference raises. On a CUDA machine
with one card the mesh is n virtual shards on that card (its line says
so); with several cards it takes n of them, and raises when there are
fewer.

    python3 -m adacom_tpu_torch.graft_entry [--platform cuda|cpu] [n]
"""

from __future__ import annotations

import sys

import numpy as np


def entry(platform: str = "cuda"):
    import torch

    from adacom_tpu_torch import types as tt
    from adacom_tpu_torch.main.database import resolve_device
    from adacom_tpu_torch.ops import fused_scan, segcodec

    dev = resolve_device(platform)
    seg_rows = 4096
    vals = torch.from_numpy(
        np.arange(100_000, 100_000 + seg_rows, dtype=np.uint32)).to(dev)
    packed = segcodec.pack_segment(vals, tt.UINTEGER)
    words = packed.words[0].unsqueeze(0)  # (1, width, n_lanes)
    example_args = (words, [seg_rows], [packed.min_factor], 100_100, 100_999)
    return fused_scan.scan_table, example_args


def _mesh_for(n_devices: int, platform: str):
    import torch

    from adacom_tpu_torch.parallel import mesh as pmesh

    if platform == "cuda" and torch.cuda.device_count() != 1:
        return pmesh.make_mesh(n_devices, "cuda")
    return pmesh.make_virtual_mesh(n_devices, platform)


def _check(cond, what):
    if not cond:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, platform: str = "cuda", mesh=None
                     ) -> str:
    import torch

    import adacom_tpu_torch as att
    from adacom_tpu_torch import types as tt
    from adacom_tpu_torch.ops import segcodec
    from adacom_tpu_torch.parallel import mesh as pmesh
    from adacom_tpu_torch.parallel import ops as pops

    if mesh is None:
        mesh = _mesh_for(n_devices, platform)
    dev = mesh.devices[0]
    sh = lambda a: pmesh.shard_leading(mesh, torch.as_tensor(a).to(dev))  # noqa: E731

    # --- stage 0: SQL on the mesh (Database(mesh=...)): the distributed
    # pooled scan-aggregate (TPC-H Q1/Q6 shapes) and the shuffle join,
    # against numpy; dist_stats show that the distributed paths ran
    cfg = att.DBConfig()
    cfg.segment_rows = 1024
    cfg.host_scan_segment_limit = 0
    cfg.distributed_join_rows = 1
    db = att.Database(config=cfg, platform=dev.type, mesh=mesh)
    con = db.connect()
    rng0 = np.random.default_rng(42)
    con.query("CREATE TABLE li(flag INTEGER, qty BIGINT, price BIGINT)")
    flag = rng0.integers(0, 3, 8192).astype(np.int32)
    qty = rng0.integers(1, 50, 8192).astype(np.int64)
    price = rng0.integers(100, 10_000, 8192).astype(np.int64)
    app = con.appender("li")
    app.append_columns({"flag": flag, "qty": qty, "price": price})
    app.close()
    db.catalog.get_column_segment_catalog().compact_all_segments()
    # Q6 shape: a filtered ungrouped aggregate
    r = con.query("SELECT sum(price), count(*) FROM li WHERE qty < 25"
                  ).fetchone()
    m = qty < 25
    _check(int(r[0]) == int(price[m].sum()) and int(r[1]) == int(m.sum()),
           f"Q6 shape {r}")
    # Q1 shape: a dense grouped aggregate
    rows = con.query("SELECT flag, sum(qty), count(*) FROM li GROUP BY flag "
                     "ORDER BY flag").fetchall()
    _check(len(rows) == 3, f"Q1 shape: {len(rows)} groups")
    for row in rows:
        f = int(row[0])
        _check(int(row[1]) == int(qty[flag == f].sum()) and
               int(row[2]) == int((flag == f).sum()), f"Q1 shape {row}")
    _check(db.dist_stats["scan_agg"] > 0,
           "the distributed scan-aggregate did not run")
    # a PK-FK shuffle join
    con.query("CREATE TABLE ords(okey INTEGER, cust INTEGER)")
    okey = np.arange(2048, dtype=np.int32)
    cust = (okey * 3 % 97).astype(np.int32)
    app = con.appender("ords")
    app.append_columns({"okey": okey, "cust": cust})
    app.close()
    con.query("CREATE TABLE items(okey INTEGER, amt BIGINT)")
    i_ok = rng0.integers(0, 4096, 8192).astype(np.int32)
    i_amt = rng0.integers(1, 100, 8192).astype(np.int64)
    app = con.appender("items")
    app.append_columns({"okey": i_ok, "amt": i_amt})
    app.close()
    jr = con.query("SELECT count(*), sum(i.amt) FROM items i JOIN ords o "
                   "ON i.okey = o.okey").fetchone()
    jm = i_ok < 2048
    _check(int(jr[0]) == int(jm.sum()) and
           int(jr[1]) == int(i_amt[jm].sum()), f"join {jr}")
    _check(db.dist_stats["join"] > 0, "the shuffle join did not run")
    db.close()

    # --- stage 1: segment-parallel fused scan-aggregate (dp over segments)
    seg_rows = 1024
    n_seg = n_devices * 2
    rng = np.random.default_rng(0)
    packs, datas = [], []
    for _s in range(n_seg):
        vals = (50_000 + rng.integers(0, 1 << 12, seg_rows)).astype(np.uint32)
        datas.append(vals)
        packs.append(segcodec.pack_segment(
            torch.from_numpy(vals).to(dev), tt.UINTEGER,
            vmin=50_000, vmax=50_000 + (1 << 12)))
    widths, n_lanes = packs[0].widths, packs[0].n_lanes
    words, mins, counts = pops.stack_packed_segments(packs, n_lanes)
    scan_fn = pops.make_distributed_scan_agg(
        mesh, widths, n_lanes, predicate=lambda v, p: v < p)
    s, c = scan_fn(sh(words), sh(mins), sh(counts), 52_000)
    all_vals = np.concatenate(datas)
    m = all_vals < 52_000
    _check(int(c) == int(m.sum()), f"scan-agg count {int(c)}")
    _check(int(s) == int(all_vals[m].astype(np.int64).sum()),
           f"scan-agg sum {int(s)}")

    # --- stage 2: all_to_all hash repartition + distributed group-by
    n = n_devices * 256
    domain = 32
    keys = rng.integers(0, domain, n).astype(np.int64)
    vals = rng.integers(0, 1000, n).astype(np.int64)
    valid = np.ones(n, dtype=bool)
    gb = pops.make_distributed_groupby_sum(mesh, capacity=n, domain=domain)
    sums, _cnts = gb(sh(keys), sh(valid), sh(vals))
    exp = np.zeros(domain, np.int64)
    np.add.at(exp, keys, vals)
    _check(np.array_equal(sums.cpu().numpy(), exp), "all_to_all group-by")

    # --- stage 3: the skew-immune pre-aggregating group-by (combiner)
    gb2 = pops.make_distributed_groupby_preagg(mesh, domain=domain)
    sums2, _cnts2 = gb2(sh(keys), sh(valid), sh(vals))
    _check(np.array_equal(sums2.cpu().numpy(), exp), "preagg group-by")

    # --- stage 4: the distributed shuffle hash join (PK-FK)
    nb = n_devices * 64
    build_keys = np.arange(nb, dtype=np.int64)
    probe_keys = rng.integers(0, nb * 2, n).astype(np.int64)
    probe_vals = np.arange(n, dtype=np.int64)
    join = pops.make_distributed_join(mesh, capacity=max(n, nb))
    matched, bx_out, _px_out, pk_out = join(
        sh(build_keys), sh(np.ones(nb, bool)), sh(build_keys * 10),
        sh(probe_keys), sh(np.ones(n, bool)), sh(probe_vals))
    m_np = pmesh.gather_leading(matched).cpu().numpy()
    _check(int(m_np.sum()) == int((probe_keys < nb).sum()),
           f"shuffle join matched {int(m_np.sum())}")
    _check(np.array_equal(pmesh.gather_leading(bx_out).cpu().numpy()[m_np],
                          pmesh.gather_leading(pk_out).cpu().numpy()[m_np]
                          * 10), "shuffle join payloads")

    # --- stage 5: distributed top-k (per-shard top-k + all_gather merge)
    topk = pops.make_distributed_topk(mesh, k=8)
    tv, _tg = topk(sh(probe_vals), sh(np.ones(n, bool)))
    _check(np.array_equal(tv.cpu().numpy(), np.sort(probe_vals)[::-1][:8]),
           "top-k")

    # the hash and the destination, bit for bit with splitmix64 in uint64
    edge = np.array([0, 1, -1, 2**63 - 1, -2**63, 12345, -987654321],
                    np.int64)
    h = pops._hash64(torch.from_numpy(edge).to(dev)).cpu().numpy()
    z = edge.view(np.uint64)
    with np.errstate(over="ignore"):
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        z = z ^ (z >> np.uint64(31))
    _check(np.array_equal(h.view(np.uint64), z), "splitmix64 hash")
    d = pops._dest(torch.from_numpy(h).to(dev), n_devices).cpu().numpy()
    _check(np.array_equal(d, (z % np.uint64(n_devices)).astype(np.int64)),
           "hash destinations")

    where = (f"{mesh.size} virtual shards on {dev}" if mesh.virtual
             else f"{mesh.size} devices {[str(x) for x in mesh.devices]}")
    line = (f"dryrun_multichip({n_devices}): SQL on the mesh + scan-agg + "
            f"all_to_all group-by + preagg combiner + shuffle join + top-k "
            f"OK on mesh {mesh.shape} ({where})")
    print(line, flush=True)
    return line


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python3 -m adacom_tpu_torch.graft_entry")
    ap.add_argument("--platform", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("n", nargs="?", type=int, default=4,
                    help="shards of the mesh (default 4)")
    args = ap.parse_args(argv)
    fn, fargs = entry(args.platform)
    print("entry:", list(fn(*fargs)), flush=True)
    dryrun_multichip(args.n, args.platform)
    return 0


if __name__ == "__main__":
    sys.exit(main())
