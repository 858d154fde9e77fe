"""Mini routing gate consuming exactly one dump format."""

import json
import sys

EXPECTED_OPS = ("goodk", "goodk_adaptive")


def ledger_from_snapshot(dump):
    return dump.get("counters", {})


def main():
    dump = json.load(open(sys.argv[1]))
    ledger = ledger_from_snapshot(dump)
    return 0 if all(ledger.get(op) for op in EXPECTED_OPS) else 1


if __name__ == "__main__":
    sys.exit(main())
