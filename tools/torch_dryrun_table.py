"""The dry run's sweep as one markdown table: per (architecture, shape)
cell, rank 0's argument and temp GiB and its collective GB by kind on
(16, 16) and on (2, 16, 16), from the JSON records of

  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out DIR
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod \
      --out DIR

Usage: python tools/torch_dryrun_table.py DIR
"""
import json
import pathlib
import sys

KINDS = (("all-gather", "AG"), ("all-reduce", "AR"),
         ("reduce-scatter", "RS"), ("all-to-all", "A2A"))


def _cell(rec) -> str:
    if rec is None:
        return "no record |"
    m = rec["memory"]
    gib = [m["argument_size_in_bytes"] / 2**30,
           m["temp_size_in_bytes"] / 2**30]
    gb = [rec["collective_bytes"][k] / 1e9 for k, _ in KINDS]
    return (" / ".join(f"{x:.3f}" for x in gib) + " | "
            + " / ".join(f"{x:.2f}" for x in gb) + " |")


def main(directory: str) -> None:
    recs = {}
    for path in sorted(pathlib.Path(directory).glob("*.json")):
        rec = json.loads(path.read_text())
        recs[(rec["arch"], rec["shape"], rec["mesh"])] = rec
    order = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
    cells = sorted({(a, s) for a, s, _ in recs},
                   key=lambda c: (c[0], order.index(c[1])))
    names = " / ".join(n for _, n in KINDS)
    print(f"| arch | shape | 16x16 arg / temp GiB | {names} GB | "
          f"2x16x16 arg / temp GiB | {names} GB |")
    print("| --- | --- | --- | --- | --- | --- |")
    for arch, shape in cells:
        print(f"| {arch} | {shape} | "
              + _cell(recs.get((arch, shape, "16x16"))) + " "
              + _cell(recs.get((arch, shape, "2x16x16"))))


if __name__ == "__main__":
    main(sys.argv[1])
