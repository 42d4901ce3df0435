"""Merge per-language inference predictions into one submission file.

Port of scripts/merge_inference_predictions.py (reference
scripts/merge_inference_predictions.py:1-68), with its command line and
output: RxR runs produce one JSONL per language (en/hi/te, the
`INFERENCE.PREDICTIONS_FILE` of each `rxr_baselines/rxr_cma_*.yaml`); the
leaderboard wants a single file. Also merges r2r-format JSON prediction
dicts.

    python -m vlnce_torch.scripts.merge_inference_predictions --out merged.jsonl a.jsonl b.jsonl
    python -m vlnce_torch.scripts.merge_inference_predictions --format r2r --out merged.json a.json b.json
"""

from __future__ import annotations

import argparse
import json


def main(argv=None) -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("inputs", nargs="+")
    parser.add_argument("--out", required=True)
    parser.add_argument("--format", choices=["rxr", "r2r"], default="rxr")
    args = parser.parse_args(argv)

    if args.format == "rxr":
        entries = []
        seen = set()
        for path in args.inputs:
            with open(path) as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    entry = json.loads(line)
                    key = entry.get("instruction_id")
                    if key in seen:
                        raise ValueError(f"duplicate instruction_id {key} in {path}")
                    seen.add(key)
                    entries.append(entry)
        with open(args.out, "w") as f:
            for entry in entries:
                f.write(json.dumps(entry) + "\n")
        print(f"merged {len(entries)} predictions -> {args.out}")
    else:
        merged = {}
        for path in args.inputs:
            with open(path) as f:
                data = json.load(f)
            dupes = set(merged) & set(data)
            if dupes:
                raise ValueError(f"duplicate episode ids {sorted(dupes)[:5]}... in {path}")
            merged.update(data)
        with open(args.out, "w") as f:
            json.dump(merged, f, indent=2)
        print(f"merged {len(merged)} predictions -> {args.out}")


if __name__ == "__main__":
    main()
