"""Top-level command dispatch of the port (samtools' bamtk.c).

``python -m samtools_tpu_torch <command> [options]`` mirrors
``python -m samtools_tpu <command> [options]`` byte for byte on stdout for
every command of the JAX package; ``version`` names torch and CUDA.
"""

from __future__ import annotations

import os
import sys

from . import SAMTOOLS_PARITY_VERSION, __version__
from .core import metrics
from .core.malloc_tune import tune
from .tools import COMMANDS, run_command


def usage(out) -> None:
    out.write(f"""
Program: samtools (Tools for alignments in the SAM format)
Version: {SAMTOOLS_PARITY_VERSION} (samtools_tpu_torch {__version__})

Usage:   samtools <command> [options]

Commands:
  -- Indexing
     dict           create a sequence dictionary file
     faidx          index/extract FASTA
     fqidx          index/extract FASTQ
     index          index alignment

  -- Editing
     calmd          recalculate MD/NM tags and '=' bases
     fixmate        fix mate information
     reheader       replace BAM header
     targetcut      cut fosmid regions (for fosmid pool only)
     addreplacerg   adds or replaces RG tags
     markdup        mark duplicates
     ampliconclip   clip oligos from the end of reads

  -- File operations
     collate        shuffle and group alignments by name
     cat            concatenate BAMs
     consensus      produce a consensus Pileup/FASTA/FASTQ
     merge          merge sorted alignments
     mpileup        multi-way pileup
     sort           sort alignment file
     split          splits a file by read group
     quickcheck     quickly check if SAM/BAM/CRAM file appears intact
     fastq          converts a BAM to a FASTQ
     fasta          converts a BAM to a FASTA
     import         Converts FASTA or FASTQ files to SAM/BAM/CRAM
     reference      Generates a reference from aligned data
     reset          Reverts aligner changes in reads

  -- Statistics
     bedcov         read depth per BED region
     coverage       alignment depth and percent coverage
     depth          compute the depth
     flagstat       simple stats
     idxstats       BAM index stats
     cram-size      list CRAM Content-ID and Data-Series sizes
     phase          phase heterozygotes
     stats          generate stats (former bamcheck)
     ampliconstats  generate amplicon specific stats
     checksum       produce order-agnostic checksums of sequence content

  -- Viewing
     flags          explain BAM flags
     head           header viewer
     tview          text alignment viewer
     view           SAM<->BAM<->CRAM conversion
     depad          convert padded BAM to unpadded BAM
     samples        list the samples in a set of SAM/BAM/CRAM files

  -- Misc
     help [cmd]     display this help message or help for [cmd]
     version        detailed version information

""")


def print_version() -> None:
    import torch
    print(f"samtools {SAMTOOLS_PARITY_VERSION} "
          f"(samtools_tpu_torch {__version__})")
    print(f"Using torch {torch.__version__} (CUDA {torch.version.cuda})")
    print("Copyright (C) 2026")
    print()
    print("samtools_tpu_torch compilation details:")
    print("    Implementation:  PyTorch + hand-written CUDA kernels (sm_90a) "
          "+ C++ host I/O")
    print(f"    CUDA devices:    {torch.cuda.device_count()}")


def main(argv: list[str] | None = None, device=None) -> int:
    """Run one command.  ``device`` goes to the command's entry point:
    None means the CUDA card; the tests pass "cpu".  The allocator
    tuning (``core/malloc_tune.tune``) comes first.  After the command,
    the stage breakdown goes to stderr under ``--verbosity`` 4 or
    ``SAMTPU_METRICS=1`` (``core/metrics.report``)."""
    if argv is None:
        argv = sys.argv[1:]
    if not argv:
        usage(sys.stderr)
        return 1
    tune()
    if os.environ.get("SAMTPU_DIST_COORD"):
        from .parallel.dist import maybe_init_distributed
        maybe_init_distributed(device)
    cmd = argv[0]
    if cmd in ("help", "--help"):
        if len(argv) > 1 and argv[1] in COMMANDS:
            return run_command(argv[1], ["--help"], device)
        usage(sys.stdout)
        return 0
    if cmd in ("version", "--version"):
        print_version()
        return 0
    if cmd == "--version-only":
        print(f"{SAMTOOLS_PARITY_VERSION}+samtools_tpu_torch{__version__}")
        return 0
    if cmd not in COMMANDS:
        sys.stderr.write(f"[main] unrecognized command '{cmd}'\n")
        return 1
    # each command starts with no stages and the default verbosity, as a
    # fresh process of the JAX tool does
    metrics.reset()
    metrics.set_verbosity(metrics.DEFAULT_VERBOSITY)
    try:
        rc = run_command(cmd, argv[1:], device)
        metrics.report(cmd)
        return rc
    except BrokenPipeError:
        # downstream closed the pipe (`... | head`): exit quietly
        try:
            sys.stdout.close()
        except OSError:
            pass
        return 1
    except KeyboardInterrupt:
        return 130


if __name__ == "__main__":
    sys.exit(main())
