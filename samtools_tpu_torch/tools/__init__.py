"""Subcommand registry of the port (samtools' bamtk.c dispatch table,
and samtools' misc/ programs): every command of the JAX package."""

from __future__ import annotations

import importlib

# subcommand -> (module, function), imported when the command runs, in
# the JAX package's order
COMMANDS = {
    "view": ("samtools_tpu_torch.tools.view_cmd", "main_view"),
    "head": ("samtools_tpu_torch.tools.head_cmd", "main_head"),
    "flags": ("samtools_tpu_torch.tools.flags_cmd", "main_flags"),
    "quickcheck": ("samtools_tpu_torch.tools.quickcheck_cmd",
                   "main_quickcheck"),
    "cat": ("samtools_tpu_torch.tools.cat_cmd", "main_cat"),
    "flagstat": ("samtools_tpu_torch.tools.flagstat_cmd", "main_flagstat"),
    "idxstats": ("samtools_tpu_torch.tools.idxstats_cmd", "main_idxstats"),
    "index": ("samtools_tpu_torch.tools.index_cmd", "main_index"),
    "depth": ("samtools_tpu_torch.tools.depth_cmd", "main_depth"),
    "mpileup": ("samtools_tpu_torch.tools.mpileup_cmd", "main_mpileup"),
    "sort": ("samtools_tpu_torch.tools.sort_cmd", "main_sort"),
    "merge": ("samtools_tpu_torch.tools.merge_cmd", "main_merge"),
    "collate": ("samtools_tpu_torch.tools.collate_cmd", "main_collate"),
    "fixmate": ("samtools_tpu_torch.tools.fixmate_cmd", "main_fixmate"),
    "markdup": ("samtools_tpu_torch.tools.markdup_cmd", "main_markdup"),
    "faidx": ("samtools_tpu_torch.tools.faidx_cmd", "main_faidx"),
    "fqidx": ("samtools_tpu_torch.tools.faidx_cmd", "main_fqidx"),
    "dict": ("samtools_tpu_torch.tools.dict_cmd", "main_dict"),
    "stats": ("samtools_tpu_torch.tools.stats_cmd", "main_stats"),
    "coverage": ("samtools_tpu_torch.tools.coverage_cmd", "main_coverage"),
    "bedcov": ("samtools_tpu_torch.tools.bedcov_cmd", "main_bedcov"),
    "consensus": ("samtools_tpu_torch.tools.consensus_cmd",
                  "main_consensus"),
    "fastq": ("samtools_tpu_torch.tools.fastq_cmd", "main_fastq"),
    "fasta": ("samtools_tpu_torch.tools.fastq_cmd", "main_fasta"),
    "import": ("samtools_tpu_torch.tools.import_cmd", "main_import"),
    "split": ("samtools_tpu_torch.tools.split_cmd", "main_split"),
    "addreplacerg": ("samtools_tpu_torch.tools.addrprg_cmd",
                     "main_addreplacerg"),
    "reheader": ("samtools_tpu_torch.tools.reheader_cmd", "main_reheader"),
    "calmd": ("samtools_tpu_torch.tools.calmd_cmd", "main_calmd"),
    "fillmd": ("samtools_tpu_torch.tools.calmd_cmd", "main_calmd"),
    "checksum": ("samtools_tpu_torch.tools.checksum_cmd", "main_checksum"),
    "samples": ("samtools_tpu_torch.tools.samples_cmd", "main_samples"),
    "reset": ("samtools_tpu_torch.tools.reset_cmd", "main_reset"),
    "depad": ("samtools_tpu_torch.tools.depad_cmd", "main_depad"),
    "phase": ("samtools_tpu_torch.tools.phase_cmd", "main_phase"),
    "targetcut": ("samtools_tpu_torch.tools.targetcut_cmd",
                  "main_targetcut"),
    "rmdup": ("samtools_tpu_torch.tools.rmdup_cmd", "main_rmdup"),
    "tview": ("samtools_tpu_torch.tools.tview_cmd", "main_tview"),
    "reference": ("samtools_tpu_torch.tools.reference_cmd",
                  "main_reference"),
    "cram-size": ("samtools_tpu_torch.tools.cram_size_cmd",
                  "main_cram_size"),
    "ampliconclip": ("samtools_tpu_torch.tools.ampliconclip_cmd",
                     "main_ampliconclip"),
    "ampliconstats": ("samtools_tpu_torch.tools.ampliconstats_cmd",
                      "main_ampliconstats"),
    # ancillary (samtools' misc/ programs, not bamtk subcommands)
    "wgsim": ("samtools_tpu_torch.tools.wgsim_cmd", "main_wgsim"),
    "md5fa": ("samtools_tpu_torch.tools.misc_cmds", "main_md5fa"),
    "plot-bamstats": ("samtools_tpu_torch.tools.plot_bamstats_cmd",
                      "main_plot_bamstats"),
    "plot-ampliconstats": ("samtools_tpu_torch.tools.plot_ampliconstats_cmd",
                           "main_plot_ampliconstats"),
    "md5sum-lite": ("samtools_tpu_torch.tools.misc_cmds",
                    "main_md5sum_lite"),
    "seq_cache_populate": ("samtools_tpu_torch.tools.misc_cmds",
                           "main_seq_cache_populate"),
    "ace2sam": ("samtools_tpu_torch.tools.ace2sam_cmd", "main_ace2sam"),
    "maq2sam": ("samtools_tpu_torch.tools.convert_cmds", "main_maq2sam"),
    "bowtie2sam": ("samtools_tpu_torch.tools.convert_cmds",
                   "main_bowtie2sam"),
    "psl2sam": ("samtools_tpu_torch.tools.convert_cmds", "main_psl2sam"),
    "soap2sam": ("samtools_tpu_torch.tools.convert_cmds", "main_soap2sam"),
    "zoom2sam": ("samtools_tpu_torch.tools.convert_cmds", "main_zoom2sam"),
    "novo2sam": ("samtools_tpu_torch.tools.convert_cmds", "main_novo2sam"),
    "export2sam": ("samtools_tpu_torch.tools.convert_cmds",
                   "main_export2sam"),
    "fasta-sanitize": ("samtools_tpu_torch.tools.convert_cmds",
                       "main_fasta_sanitize"),
    "blast2sam": ("samtools_tpu_torch.tools.convert_cmds", "main_blast2sam"),
    "interpolate_sam": ("samtools_tpu_torch.tools.convert_cmds",
                        "main_interpolate_sam"),
    "wgsim_eval": ("samtools_tpu_torch.tools.wgsim_eval_cmd",
                   "main_wgsim_eval"),
}

# commands that do no device work and take no ``device``
HOST_COMMANDS = ("view", "head", "flags", "quickcheck", "cat", "idxstats",
                 "index", "sort", "merge", "collate", "fixmate", "markdup",
                 "faidx", "fqidx", "dict", "fastq", "fasta", "import",
                 "split", "addreplacerg", "reheader", "calmd", "fillmd",
                 "checksum", "samples", "reset", "depad", "rmdup",
                 "reference", "cram-size", "ampliconclip", "ampliconstats",
                 "plot-bamstats", "plot-ampliconstats", "wgsim", "md5fa",
                 "md5sum-lite", "seq_cache_populate", "ace2sam", "maq2sam",
                 "bowtie2sam", "psl2sam", "soap2sam", "zoom2sam", "novo2sam",
                 "export2sam", "fasta-sanitize", "blast2sam",
                 "interpolate_sam", "wgsim_eval")


def run_command(name: str, argv: list[str], device=None) -> int:
    """Run one subcommand; ``device`` as the port's entry points take it
    (None: the CUDA card)."""
    mod_name, fn_name = COMMANDS[name]
    fn = getattr(importlib.import_module(mod_name), fn_name)
    return fn(argv) if name in HOST_COMMANDS else fn(argv, device=device)
