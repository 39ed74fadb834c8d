#!/usr/bin/env python3
"""Overcooked2 ("simplecooked") benchmark/validation CLI on the port
(counterpart of ``scripts/overcooked2_example.py``; reference:
scripts/overcooked2_example.py): ``torch_overcooked_example.py``'s flags on
the v2 rules, layout ``simple`` by default.

    python3 scripts/torch_overcooked2_example.py --validation --asserts
"""

from torch_overcooked_example import overcooked_main


def main(argv=None):
    return overcooked_main("v2", argv)


if __name__ == "__main__":
    main()
