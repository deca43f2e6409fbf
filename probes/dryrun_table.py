"""PERF.md's table of the dry run: one row an arch from the report of
`python -m repro_torch.launch.dryrun --all --both-meshes --out R.json`.

    PYTHONPATH=src python probes/dryrun_table.py R.json

A train cell: argument bytes a rank (GiB), FLOPs a rank (TFLOP, aten
matmul / conv / attention), collective bytes a rank (GB: all-gather /
all-reduce / reduce-scatter), and "Z" where the cell takes ZeRO-DP. A
serving cell: its argument bytes a rank (GiB). Every figure is a count
made on the CPU; nothing here is a time."""
import json
import sys


def _train(rec):
    if rec is None or rec["status"] != "ok":
        return rec["status"] if rec else "-"
    c = rec["collective_bytes_per_device"]
    z = "" if rec["tensor_parallel"] else " Z"
    return (f"{rec['memory']['argument_bytes'] / 2 ** 30:.2f} / "
            f"{rec['flops_per_device'] / 1e12:.1f} / "
            f"{c['all-gather'] / 1e9:.2f}, {c['all-reduce'] / 1e9:.2f}, "
            f"{c['reduce-scatter'] / 1e9:.2f}{z}")


def _args(rec):
    if rec is None:
        return "-"
    if rec["status"] != "ok":
        return rec["status"]
    return f"{rec['memory']['argument_bytes'] / 2 ** 30:.2f}"


def main(path):
    recs = json.load(open(path))
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
        print(f"| {a} | {_train(cell.get((a, 'train_4k', '16x16')))} | "
              f"{_train(cell.get((a, 'train_4k', '2x16x16')))} | "
              + " | ".join(serving) + " |")
    n = {s: sum(r["status"] == s for r in recs)
         for s in ("ok", "skipped", "error")}
    print(f"\n{len(recs)} cells: {n['ok']} ok, {n['skipped']} skipped, "
          f"{n['error']} errors; trace s of the train cells "
          + ", ".join(f"{r['arch']} {r['mesh']} {r['trace_s']}"
                      for r in recs if r["shape"] == "train_4k"
                      and r["status"] == "ok"))


if __name__ == "__main__":
    main(sys.argv[1])
