"""Top-level dispatcher: ``python -m usher_jax <tool> [args...]``.

Maps reference binary names onto the CLI modules so shell scripts written
for the reference suite can switch with a one-word prefix change.
"""

from __future__ import annotations

import sys

TOOLS = {
    "usher": "usher_jax.cli.usher_cli",
    "usher-sampled": "usher_jax.cli.usher_sampled_cli",
    "matOptimize": "usher_jax.cli.matoptimize_cli",
    "matUtils": "usher_jax.cli.matutils_cli",
    "ripples": "usher_jax.cli.ripples_cli",
    "ripples-fast": "usher_jax.cli.ripples_cli",
    "ripplesInit": "usher_jax.cli.ripples_init_cli",
    "ripplesUtils": "usher_jax.cli.ripples_utils_cli",
    "ripples-filter": "usher_jax.cli.ripples_filter_cli",
    "transpose_vcf": "usher_jax.cli.transpose_vcf_cli",
    "compareVCF": "usher_jax.cli.compare_vcf_cli",
    "check_samples_place": "usher_jax.cli.check_samples_cli",
    "usher_server": "usher_jax.cli.usher_server_cli",
    "usher-sampled-server": "usher_jax.cli.usher_socket_server_cli",
    "faToVcf": "usher_jax.io.fatovcf",
}


def main() -> int:
    if len(sys.argv) < 2 or sys.argv[1] in ("-h", "--help"):
        print("usage: python -m usher_jax <tool> [args...]\n\ntools:",
              file=sys.stderr)
        for name in TOOLS:
            print(f"  {name}", file=sys.stderr)
        return 0 if len(sys.argv) >= 2 else 1
    tool = sys.argv[1]
    mod_name = TOOLS.get(tool)
    if mod_name is None:
        print(f"ERROR: unknown tool '{tool}'; run with --help for the list",
              file=sys.stderr)
        return 1
    import importlib
    mod = importlib.import_module(mod_name)
    return mod.main(sys.argv[2:])


if __name__ == "__main__":
    sys.exit(main())
