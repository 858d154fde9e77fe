"""Mini routing gate with a legacy two-format fallback (RS205)."""

import json
import sys

EXPECTED_OPS = ("goodk",)


def ledger_from_snapshot(dump):
    return dump.get("counters", {})


def main():
    dump = json.load(open(sys.argv[1]))
    is_snapshot = "counters" in dump
    ledger = ledger_from_snapshot(dump) if is_snapshot else dump  # RS205
    return 0 if all(ledger.get(op) for op in EXPECTED_OPS) else 1


if __name__ == "__main__":
    sys.exit(main())
