"""SAM FLAG bits and CIGAR op constants the port uses (SAM spec; the
reference lists them in bam_flags.c)."""

FPAIRED = 0x1
FPROPER_PAIR = 0x2
FUNMAP = 0x4
FMUNMAP = 0x8
FREVERSE = 0x10
FMREVERSE = 0x20
FREAD1 = 0x40
FREAD2 = 0x80
FSECONDARY = 0x100
FQCFAIL = 0x200
FDUP = 0x400
FSUPPLEMENTARY = 0x800

FLAG_NAMES = [
    ("PAIRED", FPAIRED),
    ("PROPER_PAIR", FPROPER_PAIR),
    ("UNMAP", FUNMAP),
    ("MUNMAP", FMUNMAP),
    ("REVERSE", FREVERSE),
    ("MREVERSE", FMREVERSE),
    ("READ1", FREAD1),
    ("READ2", FREAD2),
    ("SECONDARY", FSECONDARY),
    ("QCFAIL", FQCFAIL),
    ("DUP", FDUP),
    ("SUPPLEMENTARY", FSUPPLEMENTARY),
]

# CIGAR operations, BAM encoding order "MIDNSHP=X"
CMATCH = 0
CINS = 1
CDEL = 2
CREF_SKIP = 3
CSOFT_CLIP = 4
CHARD_CLIP = 5
CPAD = 6
CEQUAL = 7
CDIFF = 8

# Per-op: does the op consume query / reference bases?
CIGAR_CONSUMES_QUERY = [1, 1, 0, 0, 1, 0, 0, 1, 1, 0]
CIGAR_CONSUMES_REF = [1, 0, 1, 1, 0, 0, 0, 1, 1, 0]

# 4-bit base codes (seq_nt16): =ACMGRSVTWYHKDBN
SEQ_NT16_STR = "=ACMGRSVTWYHKDBN"
