"""Subcommand registry of the port (samtools' bamtk.c dispatch table):
the commands ported so far."""

from __future__ import annotations

import importlib

# subcommand -> (module, function), imported when the command runs
COMMANDS = {
    "mpileup": ("samtools_tpu_torch.tools.mpileup_cmd", "main_mpileup"),
    "bedcov": ("samtools_tpu_torch.tools.bedcov_cmd", "main_bedcov"),
    "coverage": ("samtools_tpu_torch.tools.coverage_cmd", "main_coverage"),
    "depth": ("samtools_tpu_torch.tools.depth_cmd", "main_depth"),
    "consensus": ("samtools_tpu_torch.tools.consensus_cmd",
                  "main_consensus"),
    "flagstat": ("samtools_tpu_torch.tools.flagstat_cmd", "main_flagstat"),
    "stats": ("samtools_tpu_torch.tools.stats_cmd", "main_stats"),
}


def run_command(name: str, argv: list[str], device=None) -> int:
    """Run one subcommand; ``device`` as the port's entry points take it
    (None: the CUDA card)."""
    mod_name, fn_name = COMMANDS[name]
    return getattr(importlib.import_module(mod_name), fn_name)(
        argv, device=device)
