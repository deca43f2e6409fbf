"""PERF.md's table of the dry run: one row an arch from the report of
`python -m repro_torch.launch.dryrun --all --both-meshes --out R.json`.

    PYTHONPATH=src python probes/dryrun_table.py R.json [--before B.json]

With `--before` (a report of the same train cells without sequence
parallelism, `--shape train_4k --both-meshes --no-sp --out B.json`) a
sequence-parallel train cell also gives its collective GB without SP in
brackets, and a last line sums each kind over those cells, without ->
with SP.

A train cell: argument bytes a rank (GiB), FLOPs a rank (TFLOP, aten
matmul / conv / attention), collective bytes a rank (GB: all-gather /
all-reduce / reduce-scatter), "Z" where the cell takes ZeRO-DP and "SP"
where it runs sequence parallel. A
serving cell: its argument bytes a rank (GiB). Every figure is a count
made on the CPU; nothing here is a time."""
import argparse
import json


def _train(rec, old):
    if rec is None or rec["status"] != "ok":
        return rec["status"] if rec else "-"
    z = ("" if rec["tensor_parallel"] else " Z") + \
        (" SP" if rec.get("sp") else "")
    was = old.get((rec["arch"], rec["mesh"])) if rec.get("sp") else None
    return (f"{rec['memory']['argument_bytes'] / 2 ** 30:.2f} / "
            f"{rec['flops_per_device'] / 1e12:.1f} / "
            f"{_gb(rec['collective_bytes_per_device'])}{z}"
            + (f" ({_gb(was)})" if was else ""))


def _args(rec):
    if rec is None:
        return "-"
    if rec["status"] != "ok":
        return rec["status"]
    return f"{rec['memory']['argument_bytes'] / 2 ** 30:.2f}"


KINDS = ("all-gather", "all-reduce", "reduce-scatter")


def _gb(c):
    return ", ".join(f"{c[k] / 1e9:.2f}" for k in KINDS)


def _sums(recs, old):
    """Each kind summed over the SP train cells, without -> with SP."""
    cells = [r for r in recs if r["shape"] == "train_4k"
             and r["status"] == "ok" and r["sp"]]
    parts = []
    for k in KINDS + ("total",):
        def tot(c):
            return sum(c[j] for j in KINDS) if k == "total" else c[k]
        a = sum(tot(old[(r["arch"], r["mesh"])]) for r in cells)
        b = sum(tot(r["collective_bytes_per_device"]) for r in cells)
        parts.append(f"{k} {a / 1e12:.2f} -> {b / 1e12:.2f} TB ({b / a:.3f})")
    print(f"\nsummed over the {len(cells)} SP train cells, a rank: "
          + "; ".join(parts))
    print("with / without SP, all-reduce and total: " + "; ".join(
        f"{r['arch']} {r['mesh']} "
        + " ".join(f"{ratio(r, old[(r['arch'], r['mesh'])], k):.3f}"
                   for k in ("all-reduce", "total")) for r in cells))


def ratio(rec, was, kind):
    c = rec["collective_bytes_per_device"]
    if kind == "total":
        return sum(c[k] for k in KINDS) / sum(was[k] for k in KINDS)
    return c[kind] / was[kind]


def main(path, before=None):
    recs = json.load(open(path))
    old = {} if before is None else {
        (r["arch"], r["mesh"]): r["collective_bytes_per_device"]
        for r in json.load(open(before))
        if r["shape"] == "train_4k" and r["status"] == "ok"}
    cell = {(r["arch"], r["shape"], r["mesh"]): r for r in recs}
    archs = list(dict.fromkeys(r["arch"] for r in recs))
    print("| arch | train_4k 16x16: GiB / TFLOP / GB AG, AR, RS | "
          "train_4k 2x16x16 | prefill_32k GiB (16x16, 2x16x16) | "
          "decode_32k | long_500k |")
    print("|---|---|---|---|---|---|")
    for a in archs:
        serving = []
        for shape in ("prefill_32k", "decode_32k", "long_500k"):
            serving.append(", ".join(_args(cell.get((a, shape, m)))
                                     for m in ("16x16", "2x16x16")))
        print(f"| {a} | {_train(cell.get((a, 'train_4k', '16x16')), old)} | "
              f"{_train(cell.get((a, 'train_4k', '2x16x16')), old)} | "
              + " | ".join(serving) + " |")
    n = {s: sum(r["status"] == s for r in recs)
         for s in ("ok", "skipped", "error")}
    print(f"\n{len(recs)} cells: {n['ok']} ok, {n['skipped']} skipped, "
          f"{n['error']} errors; trace s of the train cells "
          + ", ".join(f"{r['arch']} {r['mesh']} {r['trace_s']}"
                      for r in recs if r["shape"] == "train_4k"
                      and r["status"] == "ok"))
    if old:
        _sums(recs, old)


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("report")
    ap.add_argument("--before", default=None)
    args = ap.parse_args()
    main(args.report, args.before)
