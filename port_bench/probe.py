"""A run of a cell with its control or with a fault planted, to show that
the comparison with the reference fails them; the benchmark's own runs
never do this.

    python3 -m port_bench.probe --probe <name> --workload <cell> \\
        --seed <n> --seconds <s> [--device cpu]

``none``: the cell as it is, with ``--set key=value`` (a JSON value) in
its traffic mix, as a sweep of the clients takes it.  ``control``: the
program's own path one precision below the
configuration's (training: bfloat16 params for float32; serving: int8
weights and int8 KV pools for bfloat16).  Faults: ``state_unchanged`` (the
optimizer's update does nothing), ``half_batch`` (the step sees half of
its rows, the mean taken over them), ``token_altered`` (one token a slot
changed in every decode call where it is produced).  Prints the result
line as ``port_bench.run`` does, with ``"probe"`` added.
"""

from __future__ import annotations

import argparse
import json
import sys

from port_bench import run as bench_run

CONTROLS = {
    "train": {"param_dtype": "bfloat16"},
    "serve": {"quantize": "int8", "kv_quantize": "int8"},
}


def _state_unchanged(trainer) -> None:
    type(trainer.tx).update = lambda self, state, grad_norm=None: None


def _half_batch(trainer) -> None:
    place = trainer.place_batch
    trainer.place_batch = lambda tokens: place(tokens[: len(tokens) // 2])


def _token_altered(engine) -> None:
    runner = engine.runner
    decode = runner.decode
    vocab = runner.cfg.vocab_size

    def altered(tokens, seq_lens, *a, **k):
        out = decode(tokens, seq_lens, *a, **k)
        step = out.shape[0] // 2
        for slot in range(out.shape[1]):
            if seq_lens[slot] > 1:
                out[step, slot] = (out[step, slot] + 1) % vocab
        return out

    runner.decode = altered


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "token_altered": _token_altered}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--probe", required=True,
                    choices=("none", "control") + tuple(FAULTS))
    ap.add_argument("--set", action="append", default=[])
    args, rest = ap.parse_known_args(argv)
    traffic = {k: json.loads(v) for k, v in
               (item.split("=", 1) for item in args.set)}
    cell = bench_run.harness.Cell(bench_run.ROOT,
                                  bench_run.parse(rest).workload)
    if args.probe == "control":
        out = bench_run.execute(
            rest, engine_overrides=CONTROLS[cell.driver().CHECKS],
            traffic_overrides=traffic)
    else:
        out = bench_run.execute(rest, plant=FAULTS.get(args.probe),
                                traffic_overrides=traffic)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    line = json.loads(bench_run.harness.result_line(**out))
    line["probe"] = args.probe
    print(json.dumps(line, ensure_ascii=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
