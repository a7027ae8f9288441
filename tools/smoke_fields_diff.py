#!/usr/bin/env python3
"""Compare the non-timing fields of two `chip_smoke.py` logs.

    python3 tools/smoke_fields_diff.py OLD.log NEW.log

Reads the `{"summary": ...}` line of each log (the per-path records the
script prints before its kernels line) and lists every field whose value
differs, leaving out what is a time, a rate or memory the allocator
holds: keys naming ms, frames or cell-steps per second, peak or held
memory, and the CLI's timed lines.  What is left is what a change that
keeps the kernels' arithmetic must repeat: div_inf, iterations, active
substeps, drops, launch counts, residuals, the errors against plain
versions and the cells apart between layouts.  Fields only one log has
are listed as added or gone.  Exits 1 when a shared field differs.
"""

from __future__ import annotations

import json
import sys

TIMING = ("ms", "per_s", "memory", "cli_line", "frames_per_s", "seconds")


def summary(path: str) -> dict:
    """The `summary` object of the log at `path`."""
    with open(path, encoding="utf-8") as f:
        for line in f:
            if line.startswith('{"summary"'):
                return json.loads(line)["summary"]
    raise SystemExit(f"{path}: no summary line")


def timing(key: str) -> bool:
    return any(word in key for word in TIMING)


def walk(old, new, path="", out=None):
    """(path, old, new) of every differing non-timing leaf."""
    out = [] if out is None else out
    if isinstance(old, dict) and isinstance(new, dict):
        for k in sorted(set(old) | set(new)):
            if timing(k):
                continue
            sub = f"{path}.{k}" if path else k
            if k not in new:
                out.append((sub, old[k], "(gone)"))
            elif k not in old:
                out.append((sub, "(added)", new[k]))
            else:
                walk(old[k], new[k], sub, out)
    elif (isinstance(old, list) and isinstance(new, list)
          and len(old) == len(new)):
        for i, (a, b) in enumerate(zip(old, new)):
            walk(a, b, f"{path}[{i}]", out)
    elif old != new:
        out.append((path, old, new))
    return out


def main(argv) -> int:
    if len(argv) != 3:
        print(__doc__, file=sys.stderr)
        return 2
    diffs = walk(summary(argv[1]), summary(argv[2]))
    changed = [d for d in diffs if "(added)" not in d and "(gone)" not in d]
    for path, a, b in diffs:
        print(f"{path}: {a} -> {b}")
    print(f"{len(changed)} shared non-timing fields differ; "
          f"{len(diffs) - len(changed)} added or gone")
    return 1 if changed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
