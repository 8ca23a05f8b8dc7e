"""Convert a binary TASO substitution catalog (.pb) to its JSON twin
(flexflow_tpu's tools/pb_to_json.py): the wire bytes decoded by
pcg/taso_pb.py and written in the same JSON schema (rules named
taso_rule_{i}, 2-space indent).

Usage: python -m flexflow_tpu_torch.tools.pb_to_json <input.pb> <output.json>
"""
import json
import sys


def main(argv):
    """`argv` as sys.argv: the program's name, then the two paths."""
    if len(argv) != 3:
        print(f"Usage: {argv[0]} <input-file> <output-file>",
              file=sys.stderr)
        return 1
    from ..pcg.taso_pb import pb_to_dict

    d = pb_to_dict(argv[1])
    print(f"Loaded {len(d['rule'])} rules.")
    with open(argv[2], "w") as f:
        json.dump(d, f, indent=2)
        f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
