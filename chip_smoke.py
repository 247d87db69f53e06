"""Smoke test of the PyTorch/CUDA port (samtools_tpu_torch) on one card.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and ``g++``; builds everything it runs
from the sources in this checkout.  Phases, one JSON line each:

1. build — the host library and the CUDA kernels, compiled in parallel;
   ptxas's registers, shared memory and spills per kernel, and K4's launch
   geometry (checkpoint stride, dynamic shared memory, scratch).
2. kernels — K1 in its two forms (segment_contract, on (rp, W); its
   census form segment_census, on the chunk step's per-base tensors), K4
   baq_hmm and K5 baq_finalize on the card at the shapes the main path
   gives them (a chunk of 65,536 reads of 100 bases; K1 also on the same
   with a deep pile), each held against its plain PyTorch version on the
   same inputs: K1 and K5 exactly; K4, on every read that neither version
   flags risky, with ``good`` equal, min(bq, qual) equal on M bases (what
   the risky flag guards) and raw bq equal on M bases where both versions
   give bq <= qual + 1, and at most 1% of reads in the symmetric
   difference of the risky sets (f32 summation order differs).  K4's
   device memory for one call must be its checkpoint scratch plus its
   outputs (no forward trace).  Times are CUDA-event medians of 5 single
   calls (``ms``, the wrapper's host time included); each kernel's
   ``b2b_ms`` is the median of 5 groups of 10 calls made back to back,
   where the host's time overlaps the card's work as on the main path.
   Beside the census form, the cost it replaces: the weight build alone
   and the weight build followed by the generic form, back to back; its
   library call is ``index_add_`` of the same packed int32 weights.  K1's,
   K4's and K5's ``device_ms``: a CUDA graph of wrapper calls (each
   wrapper only allocates its outputs and launches).  The
   generic form must launch here: the main path no longer calls it.
   K6's front, ``chunk_expand`` (csrc/chunk_expand.cu: the buffer parse,
   the cigar expansion and the reference-window gather), and its tail,
   ``qual_deltas`` (csrc/qual_deltas.cu: the changed quals compacted in
   order at capacity C x 100 / 16), on the same clean and messy chunks,
   each equal to its plain version byte for byte, with ``device_ms`` (a
   CUDA graph of the bare C entry on preallocated outputs) and, for
   qual_deltas, ``torch.nonzero`` of the flat mask as its library call
   (none computes a cigar expansion).  Then K6, the chunk step
   (``_chunk_step``: chunk_expand, K4, K5, K1's census form) on the clean
   chunk, in the census core's form and in the tool's (with qual_deltas),
   its ``device_ms`` a CUDA graph of chunk steps, its bound the sum of
   its five kernels'.
3. main path — 8 Mbp x 30x x 100 bp simulated reads (the JAX package's
   bench workload) and its messy indel/soft-clip variant, written as BAMs
   by the port's writer (the two simulated in two processes at once),
   streamed through BamStream ->
   DeviceCensusPipeline -> finish() / finish_checksum(); the census and
   the qual sums must equal the single-core f64 oracle
   (io.native.bench_baq_census) over the same records exactly, and the
   checksums must equal census_checksum of the oracle's arrays.  The
   census form, K4 and K5 must have launched during the run, the generic
   K1 not, and finish() must have fetched through K7n census_narrow (one
   cooperative launch); its time is beside that of the int32 fetch it
   replaced.
4. tool -- the user's entry point, ``python -m samtools_tpu_torch
   mpileup -f ref.fa in.bam``, run in-process (``cli.main``, ``-o`` to a
   file) on the same two BAMs: tool wall, aligned Mbases/s, output bytes
   and rows, windows, host-routed and risky reads, and the launches of
   each kernel over the run.  Each window's ``--census-out`` checksum must
   equal the oracle census of phase 3 over the window's columns, the
   windows' starting reads must add up to the oracle's reads, and the run
   must launch chunk_expand, the census form, K4 and K5 and never the
   generic K1, qual_deltas and chunk_expand once a device chunk and K7
   (``census_checksum``) once a device window.
   Then the command itself, as a subprocess, on a 512 kbp x 30x BAM of
   overlapping messy pairs (so the overlap tweak runs), once with the
   card's engine and once with ``SAMTPU_DEVICE=0`` (the host's f64 HMM,
   no torch kernel): the two outputs must be byte-equal.
5. kernels_pileup -- K1's generic form at the pileup family's shapes, held
   against its plain version and against ``index_add_``: the clean BAM's
   depth difference events over one whole-contig plan (K = 1), and the
   coverage items of its first streamed window (K = 4); each with the
   share of its items that take the global-atomic path (emulated from the
   kernel's piece cut).  Then K9's two kernels on K1's outputs, each equal
   to its plain version (scripts/torch_apply_depth_kernels.py's rows):
   ``depth_scan`` (csrc/depth_scan.cu) on the depth column, its
   ``device_ms`` into pinned host memory (as the wrapper fetches) and into
   card memory, its bound in two parts (HBM, and the L values at the
   width their max picks across the host link at its peak; beside it,
   at the pinned rate measured), and at its narrowing edges;
   ``cov_reduce`` (csrc/cov_reduce.cu) on the
   coverage census and at its edges.  ``library_ms``: ``torch.cumsum`` of
   the column (the scan only); none for the reduction.
6. pileup_family -- ``depth``, ``coverage`` and ``bedcov``, the commands
   a user runs: depth (default) on clean and messy, ``depth -a -q 13 -J``
   on clean's front (the reads that start in its first 2 Mbp, written as
   a BAM of their own), ``depth -s`` on the pairs, ``coverage`` (streamed)
   on clean (8 windows) and on messy's front (2 windows) and ``coverage
   -r sim1:1-2000000`` on clean, each in-process (``cli.main``) on the
   card and, as its host twin (below), with ``SAMTPU_DEVICE=0`` (numpy):
   byte-equal outputs, the card runs launch K1's generic form and K9
   (depth: ``depth_scan``; coverage: a ``cov_reduce`` a window, as many as
   K1's launches) and nothing else.  Then ``bedcov`` as two subprocesses
   at once (``cli.main`` as ``python -m`` runs it, the launches printed
   on standard error), clean's front on standard input and a BED of
   1,000 intervals of 1-10 kbp in its first 2 Mbp, card against
   ``SAMTPU_DEVICE=0``, byte-equal; the card's launches K1 and
   ``depth_scan``, the host's none.  Per run: wall, aligned Mbases/s,
   output bytes and rows, launches.
7. kernels_general -- K8 (``baq_apply``: its front ``apply_expand``, K4
   and K5) on a group of 65,536 all-M reads of 100 bases from the clean
   BAM against its plain version (applied quals equal on every read
   neither flags risky, at most 1% of reads in the symmetric difference of
   the risky sets; the front byte for byte, with its own row), K8's
   ``device_ms`` a CUDA graph of its three bare entries,
   then ``apply_baq_batch`` through K8 with the host recompute of the
   risky reads equal to ``io.native.baq_batch`` exactly; K13
   (``stable_order``, ``torch.sort(stable=True)``) on the entry positions
   of the clean BAM's first 1 Mi window equal to
   ``np.argsort(kind="stable")`` exactly.  Beside each, the host
   alternative's time (``io.native.baq_batch``, ``np.argsort``).
8. general -- mpileup's general path and ``coverage -m`` in-process:
   ``mpileup -f ref.fa -s -O`` streamed over clean's front (two stream
   windows of 1 Mi columns, each launching K13 and K8), whose rows less
   their two extra columns must equal the tool phase's fast-branch rows up
   to position 2,000,000 byte for byte; ``mpileup -r sim1:1-250000
   --output-extra FLAG,POS`` on messy and pairs, and ``coverage -m -r
   sim1:1-2000000`` on clean, card
   against ``SAMTPU_DEVICE=0``, byte-equal.  The card runs must launch K13
   (and for mpileup K8 with its front, K4 and K5, the front as often as
   K8) and never K1 in either form.
9. consensus -- ``consensus``, ``flagstat`` and ``mpileup --checkpoint``
   in-process, each card run against its ``SAMTPU_DEVICE=0`` run, byte
   for byte: ``consensus -r sim1:1-1000000 -o out.fa`` on clean (it must
   launch K10 and K13), ``consensus -a --show-ins yes --show-del yes -f
   fastq -r sim1:1-500000`` on messy, ``flagstat`` on clean and
   ``flagstat -O json`` on the pairs (K11 must launch); ``mpileup -f ref.fa
   --checkpoint`` on clean, which must print the tool phase's bytes, then
   resumed from its middle window's state with the output cut there and a
   half-written line appended, which must print them again.  Then K10
   (``consensus_segsum``) on the entries of the first window of the
   first run (the region's 1 Mbp of clean), as its host code built them:
   S, counts and depth equal the
   host branch's f64 ``gap5_scores`` bit for bit (and so the five output
   fields), the same bits on two calls; its plain version on the card
   (gather, ``index_add_`` in f64, atomics in no fixed order) within the
   rounding bound of two f64 sums, (n + 2) 2^-52 of each column's sum of
   |contributions|, counts and depth exactly.  The same checks hold K10
   on its hard shapes: 2,000 amplicon columns 5,000 deep (entries drawn
   from clean's window), q and q2 uniform on 1-100 over 200,000 columns
   (more distinct rows a block than an SM's L1 holds), quals binned,
   nothing kept.  Each gives ``device_ms`` (the kernel alone: a CUDA
   graph of bare C-entry calls on preallocated outputs), the distinct
   table rows of each block's columns (min, median, max; counted on the
   host) and the table bytes its entries request (128 B a kept entry,
   served by L1 or L2: the split is not measured); and
   K11 (``flagstat``) on clean's 2,516,582 reads and on one ``flagstat``
   stream batch of them, equal to its plain version and
   ``flagstat_numpy`` exactly in one launch, with ``device_ms`` (as
   K10's) and its earlier ballot form timed on the same tensors.  Beside
   each, the library alternative on the card and the host branch's time.
10. stats -- ``stats`` in-process on clean (all 8 Mbp), on the pairs and
   ``stats -r ref.fa`` on messy's front, each card run against its
   ``SAMTPU_DEVICE=0`` run, byte for byte; the card runs must launch K12
   (``stats_hists``) at least once per 65,536-record chunk and nothing
   else, the host runs nothing.  Per run: wall, reads/s, aligned
   Mbases/s, output bytes and rows, launches.
11. kernels_stats -- K12 on the first 65,536 reads of clean and of the
   pairs (nbases 300) and on 16,384 synthetic reads of 30-1,000 bases
   (nbases 1,000), and on its hard shapes (clean's chunk with quals
   binned to 4 values, with gaps of 8,192 reads in oidx, one read; 65,536
   reads a quarter of them with no bases; 200 reads of 20,000 bases), each
   equal to its plain version on the card and to the host library's
   ``stats_orig_hists`` exactly, beside five ``torch.bincount`` calls on
   fused keys and the host pass's time, with ``device_ms`` (as K10's),
   the launch plan and the global atomics the plan implies (each block's
   nonzero cells, counted on the host); K7n
   on the census core's clean census (8,388,608 rows, u8 counts), on its
   first 1 Mi rows (the mpileup tool's window) and on a census of 300x
   reads over 4 kbp (u16 counts), equal to its plain version in one
   launch, beside ``amax`` with ``.to()``, with ``device_ms`` (the
   cooperative kernel alone, without the host's read of the maxima), the
   share of rows staged in shared memory and its earlier two-pass form
   timed on the same census; K7 (``census_checksum_dev``,
   csrc/census_checksum.cu) on the clean census (8,388,608 rows) and on
   its first 1 Mi (the tool's window), equal to its plain version on the
   card and to ``census_checksum`` in one launch, with ``device_ms`` (a
   CUDA graph of the bare C entry, the output's zeroing included),
   beside ``torch.sum`` of the weighted lanes.
12. regions -- ``index`` in-process on clean (BAI), ``index -c`` on a
   copy (CSI); ``BamStream.query`` through each on five seeded regions
   (1 kbp, 1 kbp around a read whose bytes cross a BGZF block boundary,
   100 kbp, 2 Mbp, the contig's last 50 kbp) equal to the whole-file
   batch filtered by overlap, record for record; ``idxstats`` through the
   BAI and the CSI equal to ``idxstats`` on an unindexed copy.  Then, on
   the card, ``mpileup -f ref.fa -r sim1:3000001-4000000`` and ``depth -a
   -r sim1:3000001-4000000`` on the indexed BAM against the unindexed
   copy, and ``consensus -r sim1:1-1000000`` against the consensus
   phase's run on the then unindexed file: the same bytes and the same
   kernels launched, the walls side by side.  Last, a SAM of clean's
   reads that start in its first 500 kbp: ``mpileup -f ref.fa``,
   ``flagstat`` and ``stats`` on it print the bytes of the same commands
   on the BAM of those reads (less stats' command-line line) and launch
   the same kernels.
13. cram -- clean's reads that start before ``CRAM_END`` (100 kbp, about
   30,000 reads), written by the port's ``encode_cram`` as CRAM 3.0 under
   clean's header with an ``M5:`` on its ``@SQ`` line, the sequence in a
   ``REF_CACHE`` directory under its MD5, and as a BAM.  The CRAM decoded
   whole (``read_alignments``) must equal the reads field by field.  Then
   on the card ``mpileup -f ref.fa``, ``depth -a``, ``flagstat`` and
   ``stats`` on both inputs: the same bytes (less stats' command-line
   line) and the same kernels launched (K4, K5 and K1's census form in
   mpileup, K1's generic form and K9's depth scan in depth, K11 in
   flagstat, K12 in stats);
   ``idxstats`` on the CRAM equal to ``idxstats`` on the BAM, and
   ``index`` on the CRAM writing a ``.crai``.  Per run: the encode and
   decode seconds a read, and each run's wall beside its BAM twin's.
14. pileup_tools -- ``targetcut``, ``phase`` and ``tview`` on a 200 kbp
   contig (``diploid_islands``: a diploid sample with a het SNP about
   every kbp, 100 bp reads at 30x over three 40 kbp islands, the fosmids
   of a pool, about 36,000 reads): ``targetcut -f ref.fa``, ``phase``,
   ``phase -b`` and ``tview -w 120`` at an island's start, an island's
   middle and a gap (``-d T``) and once ``-d H``, each in-process on the
   card and as a process on the host branch (``SAMTPU_DEVICE=0``, four
   at a time beside the card's runs): the same bytes, and for ``-b`` the
   same three BAMs decoded.  The card runs must launch K8 with its front
   (as often as K8), K4 and K5 in ``targetcut -f``, K13 at least once a
   contig in ``targetcut`` and ``phase``, and K13 once a ``tview`` draw on a window with reads (none
   on the gap), and nothing else.  Per run: both walls (the host's with
   the interpreter's start), output bytes and lines, launches.
15. ancillary_tools -- wgsim, wgsim_eval, the aligner converters, md5fa,
   md5sum-lite, seq_cache_populate, fasta-sanitize and ace2sam (host
   commands: the phase must launch no kernel and its process make no
   CUDA context), one process started beside pileup_tools and checked
   after it: ``wgsim -S 11 -N 20000 -1 100 -2 100`` on clean's first 2
   Mbp, ``import -1 -2`` of its FASTQs; ``wgsim_eval alneval`` and
   ``unique`` on a SAM that puts every read at its true place by
   alneval's own rule (read 1 forward, read 2 reverse) and every 10th
   record 10 kbp away at MAPQ 10, and ``bowtie2sam`` of the same
   placements in bowtie's format; ``md5fa`` and ``md5sum-lite`` of
   clean's 8 Mbp FASTA, ``seq_cache_populate -subdirs 0`` of it, then
   ``view`` of the cram phase's CRAM with ``REF_CACHE`` at that cache and
   no ``-T`` (and of its BAM twin); ``fasta-sanitize`` of a FASTA with
   bad names; ``ace2sam -p -c`` and ``ace2sam`` of ``sim.ace_assembly``,
   ``view -c`` of the first behind its stderr header and ``depad -T``
   of it against the stderr consensus.  Checks: 20,000 records in each
   FASTQ, 100 bases each, with names that parse; import's BAM holds
   40,000 reads; alneval counts exactly the moved records wrong, all at
   MAPQ 10, and every record; unique keeps one record a pair;
   bowtie2sam's RNAME, POS and SEQ are the placements; md5fa's digest
   (and ordered, unordered) is the cram phase's ``@SQ`` M5, md5sum-lite
   ``hashlib.md5`` of the file; the CRAM decoded through the populated
   cache gives its BAM twin's reads; the sanitized names match SAM's
   RNAME rule, the sequences unchanged; ace2sam gives one record a read
   plus one a contig, each CIGAR holding as many query bases as its
   sequence, ``view`` counts them all, and depad gives each read the
   position and CIGAR of the unpadded output.  Per run: wall, records
   (reads, bases or bytes) a second, launches; the process's
   ``tune()``.
16. view_tools -- the host commands ``view``, ``head``, ``flags``,
   ``quickcheck`` and ``cat`` (no device work: the phase must launch no
   kernel) on clean's front (2 Mbp, 600,280 reads) and on the cram
   phase's reads (its BAM twin; the CRAM runs take its first 80 kbp,
   about 24,000 reads, so that each half ``cat`` joins holds two of the
   encoder's 10,000-record containers; they run as four processes beside
   the in-process BAM runs, as the Python CRAM encoder costs about
   0.4-1 ms a read, and each reports its launches and that it made no
   CUDA context): ``view -b``
   streamed and with ``-U`` (the whole-file path) byte-equal; ``view -h``
   to SAM parsed back by ``parse_sam`` equal to the BAM's records; the
   host library's SAM formatter byte-equal to ``format_record`` on 10,000
   reads; ``view -c -q 30 -F 0x10 -e ...`` and ``view -s 7.25 -c`` equal
   to the counts numpy takes from the batch's columns (and the
   subsample's share within 0.25 +- 0.01); ``-u``, ``-1``, ``-C -T`` and
   ``-O cram,version=3.1`` read back equal, ``-O sam.gz`` inflated to
   ``view -h``'s records; ``view -b
   sim1:1-1000000`` through the index ``index`` writes in the phase,
   byte-equal to the same region read from the unindexed file; ``head -n
   1000``; ``flags 0x63``; ``quickcheck -v`` on every output (rc 0) and
   on a copy cut by 100 bytes (rc not 0); ``cat`` of two
   halves that ``view`` wrote, as BAM and as CRAM: the same records as
   the whole (for CRAM, every container of both halves spliced).
   Per run: wall, the reads it read and a second, output bytes, launches.
17. prep_tools -- the pre-processing commands (no device work: the phase
   must launch no kernel).  On the tool phase's 512 kbp pairs (157,286
   reads), as one process beside the in-process runs (it reports its
   runs' launches and that it made no CUDA context): ``collate``, then
   ``fixmate -m``, then ``sort`` and ``sort -n``, then ``markdup -S -s
   -f`` and ``rmdup`` on the sorted pairs; collate keeps each template
   together, fixmate gives every read MQ, MC and ms, the sorts are in
   coordinate and in name order (READ1 first), markdup flags as many
   reads as its stats file's DUPLICATE TOTAL and leaves no spill file,
   rmdup removes one or two reads a duplicate pair it reports.  In a
   second process beside them, ``calmd -r`` on the front's first 1,000
   reads (the f64 HMM a read): a BQ tag on every read, no byte below
   '@'.  On clean's first 1 Mbp (its reads that start there, a cut of
   clean's 2 Mbp front): ``sort`` in memory, ``sort -m`` with an arena
   that spills four runs or more (the bytes of the in-memory run, no run
   left behind), ``sort --write-index`` read by ``idxstats``, ``sort -M`` and
   ``sort -I`` (the first 1 Mbp as FASTA) on a copy with one read in ten
   unmapped (the mapped ones in coordinate order, the unmapped ones
   last), ``--template-coordinate`` (in its order), and ``merge`` of the
   halves that ``view -e`` splits off (the whole sort's records);
   ``calmd -b`` against the first 1 Mbp (NM:i and MD:Z on every read; NM
   numpy's mismatch count and MD as many bases, on the reads inside the
   FASTA) and ``addreplacerg -r '@RG\\tID:x\\tSM:y'`` (the one @RG line,
   every read in it); every run but rmdup's and calmd -r's passes ``-@``
   and every output ``quickcheck``.  Per run: wall, reads a second,
   output bytes, launches.
18. amplicon_tools -- the viral amplicon path (no device work: the
   phase must launch no kernel and its process make no CUDA context),
   one process started beside prep_tools and checked after it: four
   samples of 50,000 reads of an ARTIC-shaped panel
   (``sim.amplicon_panel``: 98 amplicons on a 29,903-base contig, 2x150
   pairs, alternative primers, ends near and beyond the tolerance,
   indels and soft clips in primers, short, unmapped, QC-fail, secondary
   and supplementary records), simulated in the process; ``ampliconclip
   --both-ends --strand --primer-counts --rejects-file --filter-len 30
   -f`` on each, ``ampliconclip --hard-clip --original --fail
   --tolerance 3 -O sam`` on the first, ``sort`` of the four clipped
   BAMs and ``ampliconstats -s`` of them.  Checks, in numpy against the
   simulator's truth: TOTAL is WRITTEN + FILTERED, the primer counts add
   up to FORWARD + REVERSE CLIPPED, the output and the rejects hold every
   input read once, every forward read the clip moved starts at or past
   a left primer of its amplicon; the hard clip's OA tags are its clipped
   reads, each with as many bases as its CIGAR holds, and the unclipped
   reads fail QC; the sorts are in order; each sample's FREADS are its
   matching sequences and, with its failed primer matches, its reads
   that pass ``-F``; COMBINED's reads and totals are the four samples'
   sums.  Per run: wall, reads a second, launches.  plot-ampliconstats
   and plot-bamstats do not run: they draw with matplotlib, which the
   card's machine does not list (the CPU tests hold them to the JAX
   tool).
19. realign_tools -- the re-alignment round trip and the reference's
   indexes (no device work: the phase must launch no kernel and its
   processes make no CUDA context).  The tool phase's 512 kbp pairs
   (157,286 reads) get read groups grpA and grpB on alternate templates
   and none on one template in 50, written by the port's writer; one
   process runs ``collate -u``, ``fastq -1 -2 -0 -s -N -T RG``, ``fasta
   -N -o``, ``import -1 -2 -T '*'`` of fastq's two files, ``fqidx`` of
   its READ1 file and ``fqidx -r`` of 100 of its reads; beside it a
   second runs ``faidx`` of clean's 8 Mbp FASTA (without its .fai),
   ``faidx -r`` and ``faidx -i -r`` of 1,000 regions of 1-5,000 bases,
   ``dict``, ``reset`` and ``split -f '%*_%!.bam' -u`` of the pairs.
   Checks: every primary read comes out of fastq once, its sequence and
   qualities those numpy takes from the BAM's columns (reverse reads
   reverse complemented back), its RG comment its read group's, READ1 and
   READ2 names paired line for line; fasta prints the same sequences,
   READ1 then READ2; import's BAM and reset's hold the same names, flags,
   sequences, qualities and tags; split's outputs add up to the input,
   each read group's header holding only its @RG line; fqidx writes a
   line a read and fetches the 100 reads equal to their records; faidx
   writes clean's .fai and each region equals the reference's slice (with
   ``-i`` its reverse complement); dict's LN and M5 are the length and
   ``hashlib.md5`` of the upper-cased sequence.  Per run: wall, reads or
   bases a second, output bytes, launches.
20. header_tools -- reheader, samples, checksum, depad, reference and
   cram-size (no device work: the phase must launch no kernel and its
   processes make no CUDA context), in two processes started beside
   realign_tools' two, on its read-group BAM.  The header process:
   ``samples -i -f`` (the rows s1 and s2, no index, clean's FASTA);
   ``reheader`` with the header plus a @CO line, and ``reheader -P -c``
   with sed dropping grpB's @RG line (each output ends with the input's
   bytes from its second BGZF block on, its records the input's); on a
   copy of the cram phase's CRAM ``reheader -i -P -c`` adding a @CO line
   (the containers after the header's unchanged, the copy, decoded by
   ``view``, the BAM twin's reads under the new header); ``cram-size``
   and ``cram-size -v -e`` on the CRAM (the same content IDs, the
   compressed total within the file); ``calmd -b`` of clean's first
   50,000 reads and ``reference`` of its output (every base it prints
   that is not N is clean's, over 95% of the reads' span covered); and
   ``depad -T`` of messy's reads inside the contig's first 60,000
   bases, padded in this script by ``sim.pad_reads`` (each read back at
   its unpadded position and reference span).  The checksum process: the
   first 40,000 reads and their two halves (``checksum -m`` of the
   halves' reports must be the whole's), ``-a`` and ``-B`` on the
   40,000 (every read counted).  Per run: wall, reads a second, launches.
21. sharded -- K14 (``ops/pileup_device.py``, csrc/pileup_counts.cu) at
   ``graft_entry.entry()``'s shape (65,536 items, a 16,384-row window)
   and on clean's first 1 Mbp window (its reads' M bases): the scatter
   entry (counts and qual sums) and the tiled entry (the items bucketed
   in tiles of 512), each equal to its plain version exactly and to each
   other, beside ``index_put_(accumulate=True)`` on the same cells, with
   ``device_ms`` (a CUDA graph of the bare C entry), the scatter's chunks
   by path (private, global, empty) and the bound from bytes (the tiled
   entry lies on no path, its launches there are 0; its first form is
   timed in ``scripts/torch_pileup_kernels.py``).  The same checks, with
   ``device_ms``, on K14's hard shapes: 2 Mi position-sorted items two a
   row (every chunk over the private budget), 100,000 items on one cell
   and clean's 1 Mbp items back to front.  Then the mesh (K15) on the one
   card: ``make_sharded_pileup`` on a (2, 2) mesh (one K14 launch a shard), ``depth_window_sharded``
   on 4 shards over clean's front (one K1 launch a shard) and
   ``flagstat_counts_sharded`` on 4 shards over clean's stream batches
   (one K11 launch a shard that holds records), each equal to the
   unsharded run, with the sum and gather times.  Last, the span
   workers: a 2.5 Mi contig at 10x (262,144 reads), indexed; ``mpileup
   -f`` and ``consensus`` in-process under SAMTPU_SHARDS=1 and 3 (three
   worker processes on the card), the same bytes, both walls; and one
   worker's command in-process under the worker environment, which must
   launch K1's census form, K4 and K5 (mpileup) or K10 and K13
   (consensus) and print the first rows (bases) of the whole run.  Then
   a span worker's start, stage by stage (interpreter, ``import torch``,
   the port's modules, CUDA context, kernel library, first launch), one
   alone and three at once.

Host twins: where a phase holds a card run to the host branch
(``SAMTPU_DEVICE=0``; pileup_family, general, consensus, stats), the
host run is a process (``host_twin``, two at a time, all started with
the phase, beside the card's in-process runs) that must exit 0, launch no
kernel and make no CUDA context; ``host_wall_s`` is its ``cli.main``
wall, ``host_process_wall_s`` the process's from spawn.

Then the script's process: what ``core/malloc_tune.tune()`` gave its
``cli.main`` calls, and its peak RSS.  Then the
kernel table (``baq_apply``, ``apply_expand`` and ``stable_order`` with
their ``pileup_tools_launches``; ``depth_scan`` and ``cov_reduce`` with
the pileup family's launches; ``pileup_scatter``, K14, with the launches of
the sharded pileup run and its tiled entry), the script's wall against its 1,200 s limit, the
card's name and power limit, and last ``{"ok": true, "device": {...}}``.  Any failed check raises: the exit
code is not 0 and that last line is not printed.
"""

from __future__ import annotations

import atexit
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

# the H100's peaks; the CUDA-event and CUDA-graph timers
from kernel_timing import (F32_OPS_PER_S, HBM_BYTES_PER_S,  # noqa: E402
                           bound, cuda_ms, graph_ms, require)

REF_LEN = 8 << 20
COVERAGE = 30.0
READ_LEN = 100
CHUNK = 1 << 16
THREADS = max(1, min(8, os.cpu_count() or 1))

# f64 outside the tensor cores (the same data sheet): K10's adds
F64_OPS_PER_S = 34e12
# K4 f32 operations per (read, query row, band slot), counted from
# csrc/baq_hmm.cu: forward 20 (emission 1, M 6, I 4, D chain 3, row sum
# 3, normalize 3), backward 21 (emission and ee 2, bM 5, bI 3, D chain 3,
# normalize 2, decode products/sums 6)
HMM_OPS_PER_CELL = 41

# both K1 forms replace the Pallas kernel; the census form also the weight
# build of the chunk step and pack_census (K2)
KERNEL_META = {
    "segment_contract": ("samtools_tpu_torch/csrc/segment_contract.cu",
                         "samtools_tpu/ops/pileup_pallas.py:134"),
    "segment_census": ("samtools_tpu_torch/csrc/segment_contract.cu",
                       "samtools_tpu/ops/pileup_pallas.py:134"),
    "baq_hmm": ("samtools_tpu_torch/csrc/baq_hmm.cu",
                "samtools_tpu/ops/baq_device.py:114"),
    "baq_finalize": ("samtools_tpu_torch/csrc/baq_finalize.cu",
                     "samtools_tpu/ops/baq_device.py:303"),
    # K8: its front (below), K4 and K5 (the two sources above), composed
    # in ops/baq_device.py; K13: torch.sort(stable=True)
    "baq_apply": ("samtools_tpu_torch/ops/baq_device.py",
                  "samtools_tpu/ops/baq_device.py:334"),
    # K8's front (fused's unpack, codes and window gather, :350-362)
    "apply_expand": ("samtools_tpu_torch/csrc/apply_expand.cu",
                     "samtools_tpu/ops/baq_device.py:350"),
    "stable_order": ("samtools_tpu_torch/ops/pileup.py",
                     "samtools_tpu/ops/pileup.py:167"),
    "consensus_segsum": ("samtools_tpu_torch/csrc/consensus_segsum.cu",
                         "samtools_tpu/ops/consensus_vec.py:346"),
    "flagstat": ("samtools_tpu_torch/csrc/flagstat.cu",
                 "samtools_tpu/ops/flagstat.py:67"),
    "stats_hists": ("samtools_tpu_torch/csrc/stats_hists.cu",
                    "samtools_tpu/ops/stats_kernels.py:77"),
    "census_narrow": ("samtools_tpu_torch/csrc/census_narrow.cu",
                      "samtools_tpu/ops/mpileup_device.py:401"),
    # K14: its scatter entry (pileup_counts, pileup_qual_sums); the tiled
    # entry (pileup_counts_tiled, :55) is in the row's "tiled"
    "pileup_scatter": ("samtools_tpu_torch/csrc/pileup_counts.cu",
                       "samtools_tpu/ops/pileup_device.py:29"),
    # K7, the census checksum (_ck_jit), once a window of the tool's
    # --census-out and once in the census core's finish_checksum
    "census_checksum": ("samtools_tpu_torch/csrc/census_checksum.cu",
                        "samtools_tpu/ops/mpileup_device.py:376"),
    # K6's front (chunk_step's parse, cigar expansion and window gather,
    # :152-215) and tail (its collect_quals compaction, :273-279)
    "chunk_expand": ("samtools_tpu_torch/csrc/chunk_expand.cu",
                     "samtools_tpu/ops/mpileup_device.py:152"),
    "qual_deltas": ("samtools_tpu_torch/csrc/qual_deltas.cu",
                    "samtools_tpu/ops/mpileup_device.py:273"),
    # K9: the depth scan with its fetch (_depth_cumsum_jit, _fetch_narrow
    # :270) and the coverage gate and sums
    "depth_scan": ("samtools_tpu_torch/csrc/depth_scan.cu",
                   "samtools_tpu/ops/pileup_engine.py:254"),
    "cov_reduce": ("samtools_tpu_torch/csrc/cov_reduce.cu",
                   "samtools_tpu/ops/pileup_engine.py:443"),
}
# what DeviceCensusPipeline launches (the tool's engine also qual_deltas
# once a chunk and census_checksum once a window); the generic K1 runs
# only in the kernels phase
MAIN_PATH = ("segment_census", "baq_hmm", "baq_finalize", "chunk_expand")
# the pileup family's in-process runs: (label, argv, input); {name} is a
# BAM of the main path (clean, messy) or the tool phase's pairs
PILEUP_RUNS = (
    ("depth", ["depth", "{clean}"], "clean"),
    ("depth", ["depth", "{messy}"], "messy"),
    ("depth -a -q 13 -J", ["depth", "-a", "-q", "13", "-J",
                           "{clean_front}"], "clean_front"),
    ("depth -s", ["depth", "-s", "{pairs}"], "pairs"),
    ("coverage", ["coverage", "{clean}"], "clean"),
    ("coverage", ["coverage", "{messy_front}"], "messy_front"),
    ("coverage -r sim1:1-2000000",
     ["coverage", "-r", "sim1:1-2000000", "{clean}"], "clean"),
)
REGION_END = 2_000_000
# the shallower clean and messy ({clean_front}, {messy_front}): their
# reads that start before this, so rows up to it are the whole BAM's
FRONT_END = 2_000_000
# consensus -r's region on clean; the fastq run's on messy; the two-file
# general run's
REGION2_END = 1_000_000
FASTQ_END = 500_000
GENERAL2_END = 250_000
# mpileup's general path and coverage -m: (label, argv, reads counted,
# engines).  The first streams its windows and holds its rows, less the
# two extra columns, to the tool phase's fast-branch output; the others,
# card against host.
GENERAL_RUNS = (
    ("mpileup -s -O", ["mpileup", "-f", "{fa}", "-s", "-O",
                       "{clean_front}"], "clean_front", ("card",)),
    ("mpileup -r --output-extra FLAG,POS (2 files)",
     ["mpileup", "-f", "{fa}", "-r", f"sim1:1-{GENERAL2_END}",
      "--output-extra", "FLAG,POS", "{messy}", "{pairs}"], "region2",
     ("card", "host")),
    ("coverage -m -r", ["coverage", "-m", "-r", "sim1:1-2000000", "{clean}"],
     "region", ("card", "host")),
)


# the mpileup tool's window (tools/mpileup_cmd.py WINDOW_COLS): K7n's rows
# in the tool
WINDOW_ROWS = 1 << 20
_OLD_LIB = []


def kn():
    """scripts/torch_flagstat_narrow_kernels.py: the ballot K11 and the
    two-pass K7n (their forms before the redesign), and the bare C-entry
    calls of the current ones."""
    import torch_flagstat_narrow_kernels
    return torch_flagstat_narrow_kernels


def old_kernels():
    """The ballot K11 and the two-pass K7n, built once (in phase_build)."""
    if not _OLD_LIB:
        _OLD_LIB.append(kn().old_lib())
    return _OLD_LIB[0]


def pk():
    """scripts/torch_pileup_kernels.py: K14's bare C-entry calls, its
    chunk paths and the bytes it must read."""
    import torch_pileup_kernels
    return torch_pileup_kernels


def ad():
    """scripts/torch_apply_depth_kernels.py: the rows of K8's front and
    K9's two kernels (their checks against the plain versions, times
    and bounds) and their edge cases."""
    import torch_apply_depth_kernels
    return torch_apply_depth_kernels


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def ref_codes(ref: np.ndarray) -> np.ndarray:
    lut = np.full(256, 4, np.uint8)
    for i, c in enumerate(b"ACGT"):
        lut[c] = i
    return lut[ref]


# ---------------------------------------------------------------- phases
def phase_build() -> None:
    from samtools_tpu_torch import build
    from samtools_tpu_torch.ops import baq_device as bd
    from samtools_tpu_torch.ops.mpileup_device import LREF_PAD
    t0 = time.perf_counter()
    # the ballot K11 and the two-pass K7n that the kernel phases time
    # beside the current forms, compiled alongside
    with ThreadPoolExecutor(1) as ex:
        old = ex.submit(old_kernels)
        paths = build.build(("host", "cuda"))
        old.result()
    dt = time.perf_counter() - t0
    # ptxas's report; of the generic K1's 32 instantiations (one per K),
    # the one the census width uses
    ptxas, keep = [], True
    with open(paths["cuda"][:-3] + ".log") as f:
        for ln in f:
            if "entry function" in ln:
                keep = "segment_contract_kernel" not in ln or "ILi6E" in ln
            if keep and ("entry function" in ln or "registers" in ln
                         or "spill" in ln):
                ptxas.append(ln.strip())
    # dynamic shared memory is not in ptxas's report: K4's launch geometry
    # at main-path shapes, as its source fixes it
    emit({"phase": "build", "seconds": round(dt, 3), "ptxas": ptxas,
          "launch": {"baq_hmm": bd.hmm_layout(READ_LEN,
                                              READ_LEN + LREF_PAD, CHUNK)}})


def chunk_inputs(batch, ref_int: np.ndarray, ref_len: int, dev):
    """The tensors the main path hands the kernels for the first chunk of
    ``batch``: (pipeline, expanded chunk dict, lo, hi, wbeg, ntp, the
    chunk's packed buffer on the card)."""
    import torch
    from samtools_tpu_torch.ops.mpileup_device import (DeviceCensusPipeline,
                                                       classify_reads)
    pipe = DeviceCensusPipeline(ref_int, ref_len, device=dev)
    sel = np.arange(min(batch.n, CHUNK))
    elig, lead, lref, cig8 = classify_reads(batch, sel, READ_LEN, ref_len)
    dsel = sel[elig]
    pos = batch.pos[dsel].astype(np.int64)
    seqm, qual = pipe._gather_rows(batch, dsel)
    buf = pipe._make_buf(pos, lead[elig], lref[elig], cig8[elig], seqm,
                         qual, 0, dsel.size)
    lo, hi, wbeg, ntp = pipe._plan(pos)
    buf = torch.from_numpy(buf).to(dev)
    return (pipe, pipe._expand(buf), torch.from_numpy(lo).to(dev),
            torch.from_numpy(hi).to(dev), wbeg, ntp, buf)


def _k6_rows(pipe, buf, x: dict, appq, LQ: int) -> dict:
    """K6's front (``chunk_expand``) and tail (``qual_deltas``) timed on
    one chunk: the wrapper's single and back-to-back calls, the kernel
    alone (a CUDA graph of the bare C entry on preallocated outputs), the
    plain version, the library call where one computes the same function,
    and the bound from bytes."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import mpileup_device as md
    lib = kernels._load()
    C = buf.shape[0]
    names = md.EXPAND_KEYS
    outs = {k: torch.empty_like(x[k]) for k in names}
    ref, table = pipe.ref_dev, pipe._nt16_to4

    # the stream is the current one at each call: the graph's capture
    # stream while graph_ms captures
    def expand_bare():
        require(lib.samtpu_chunk_expand(
            buf.data_ptr(), C, LQ, ref.data_ptr(), ref.numel(),
            table.data_ptr(), *(outs[k].data_ptr() for k in names),
            kernels.stream_of(buf)) == 0,
            "chunk_expand's C entry point failed")
    expand_bare()
    torch.cuda.synchronize()
    require(all(torch.equal(outs[k], x[k]) for k in names),
            "chunk_expand's C entry point differs from its wrapper")
    expand = dict(
        max_abs_err=0, ms=cuda_ms(lambda: pipe._expand(buf)),
        b2b_ms=cuda_ms(lambda: pipe._expand(buf), per=10),
        device_ms=graph_ms(expand_bare),
        plain_ms=cuda_ms(lambda: md.chunk_expand_plain(buf, ref, table, LQ),
                         reps=3),
        # no PyTorch call parses a packed read buffer and walks cigars
        library_ms=None,
        library_note="no PyTorch call computes a cigar expansion",
        detail={"reads": C, "l_query": LQ},
        **dict(zip(("bound_ms", "bound_by"), bound(
            C * ((md.HDR + 2 * LQ) + (LQ + md.LREF_PAD) + 2 * LQ + 12 * LQ
                 + 12), 0))))

    qq = x["qq"]
    n = appq.numel()
    cap = n // 16
    blocks = md.deltas_plan(n)
    counts = torch.empty(blocks, dtype=torch.int32, device=appq.device)
    dcount = torch.empty((), dtype=torch.int32, device=appq.device)
    didx = torch.empty(cap, dtype=torch.int32, device=appq.device)
    dval = torch.empty(cap, dtype=torch.uint8, device=appq.device)

    def deltas_bare():
        require(lib.samtpu_qual_deltas(
            appq.data_ptr(), qq.data_ptr(), n, cap, blocks,
            counts.data_ptr(), dcount.data_ptr(), didx.data_ptr(),
            dval.data_ptr(), kernels.stream_of(appq)) == 0,
            "qual_deltas' C entry point failed")
    want = md.qual_deltas(appq, qq, cap)
    deltas_bare()
    torch.cuda.synchronize()
    require(int(dcount) == int(want[0]) and torch.equal(didx, want[1])
            and torch.equal(dval, want[2]),
            "qual_deltas' C entry point differs from its wrapper")
    mask = (appq != qq).reshape(-1)
    deltas = dict(
        max_abs_err=0, ms=cuda_ms(lambda: md.qual_deltas(appq, qq, cap)),
        b2b_ms=cuda_ms(lambda: md.qual_deltas(appq, qq, cap), per=10),
        device_ms=graph_ms(deltas_bare),
        plain_ms=cuda_ms(lambda: md.qual_deltas_plain(appq, qq, cap)),
        # the positions of the changed quals by one library call (it
        # fetches their count to size its output: a host sync)
        library_ms=cuda_ms(lambda: torch.nonzero(mask)),
        detail={"quals": n, "cap": cap, "changed": int(want[0]),
                "tiles": blocks},
        **dict(zip(("bound_ms", "bound_by"),
                   bound(2 * n + 5 * cap + 4, 0))))
    return {"chunk_expand": expand, "qual_deltas": deltas}


def phase_kernels(ref: np.ndarray, ref_int: np.ndarray, dev) -> dict:
    """Each kernel against its plain version at main-path shapes."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import baq_device as bd
    from samtools_tpu_torch.ops import mpileup_device as md
    from samtools_tpu_torch.ops import segment_kernel as sk
    from samtools_tpu_torch.sim import simulate_batch, simulate_messy
    ref_len = ref.size
    # a 30x stretch of the contig: one chunk of reads, as the stream gives
    n_sim = int(CHUNK * 1.02)
    sub_len = int(n_sim * READ_LEN / COVERAGE) + 2 * READ_LEN
    rows = {}

    # --- K4 / K5 on clean and messy chunks
    hmm_stats = []
    fin_err = 0
    hmm_t = hmm_b2b = hmm_plain_t = fin_t = fin_b2b = fin_plain_t = None
    hmm_dev = fin_dev = None
    k4_bytes = k4_ops = k5_bytes = 0
    k6_checks = []
    for messy in (False, True):
        b = simulate_batch(ref_len=sub_len, coverage=COVERAGE,
                           read_len=READ_LEN, seed=5 + messy, paired=False,
                           err_rate=0.01, ref=ref[:sub_len])
        if messy:
            simulate_messy(b, 9)
        pipe, x, lo, hi, wbeg, ntp, buf = chunk_inputs(b, ref_int, ref_len,
                                                       dev)
        C = x["sq"].shape[0]
        LQ, LRM = READ_LEN, x["ref_win"].shape[1]
        args = (x["ref_win"], x["sq"], x["qq"], x["cdT"], x["lref"],
                x["bMv"], x["bIv"], LQ, LRM, 7)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = torch.cuda.memory_allocated()
        kq, kg, kr = bd.baq_hmm(*args)
        torch.cuda.synchronize()
        # device memory one call takes: the checkpoint scratch and the
        # outputs (the caching allocator may hand each of those 4 requests
        # up to 1 MiB more than it asked)
        call_peak = torch.cuda.max_memory_allocated() - before
        scratch = bd.hmm_layout(LQ, LRM, C)["scratch_bytes"]
        own = C * (2 * LQ + 1)
        require(scratch <= call_peak <= scratch + own + (4 << 20),
                f"K4 took {call_peak} B in one call; its checkpoints are "
                f"{scratch} B and its outputs {own} B")
        pq, pg, pr = bd.baq_hmm_plain(*args)
        torch.cuda.synchronize()
        both_ok = ~(kr | pr)
        symdiff = int((kr ^ pr).sum())
        # the risky flag guards the roundings that can reach an output:
        # min(bq, qual) on M bases (bq_reaching_output).  A raw bq above
        # qual + 1, or on a non-M base, may round either way unflagged.
        ka, pa = bd.bq_reaching_output(kq, x["qq"], x["cdT"]), \
            bd.bq_reaching_output(pq, x["qq"], x["cdT"])
        bq_err = int((ka[both_ok] - pa[both_ok]).abs().max()
                     ) if both_ok.any() else 0
        good_eq = bool((kg[both_ok] == pg[both_ok]).all())
        raw = (kq != pq) & both_ok[:, None]
        # the flag's own rule (``matters``): raw roundings at or below
        # qual + 1 on M bases are flagged, so unflagged ones are equal
        qq1 = x["qq"].int() + 1
        low = (x["cdT"].t() < (1 << 19)) & (kq.int() <= qq1) \
            & (pq.int() <= qq1)
        raw_low = int((raw & low).sum())
        hmm_stats.append({"messy": messy, "reads": C,
                          "scratch_bytes": scratch,
                          "call_peak_bytes": call_peak,
                          "risky_kernel": int(kr.sum()),
                          "risky_plain": int(pr.sum()),
                          "risky_symdiff": symdiff, "bq_max_abs_err": bq_err,
                          "raw_bq_differ_bases": int(raw.sum()),
                          "raw_bq_differ_bases_at_most_qual_plus_1": raw_low,
                          "good_equal": good_eq})
        emit({"phase": "baq_hmm_check", **hmm_stats[-1]})
        require(bq_err == 0 and good_eq and raw_low == 0,
                f"K4 bq/good differ on non-risky reads (messy={messy})")
        require(symdiff <= 0.01 * C,
                f"K4 risky sets differ on {symdiff} of {C} reads")
        fk = bd.baq_finalize(kq, kg, x["qq"], x["seg"])
        fp = bd.baq_finalize_plain(kq, kg, x["qq"], x["seg"])
        fin_err = max(fin_err, int((fk.int() - fp.int()).abs().max()))
        require(fin_err == 0, "K5 differs from its plain version")
        # K6's front (chunk_inputs' tensors came through it) and tail (on
        # K5's applied quals), each against its plain version on the
        # same inputs, byte for byte
        xp = md.chunk_expand_plain(buf, pipe.ref_dev, pipe._nt16_to4, LQ)
        for k, w in xp.items():
            g = x[k]
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            require(g.shape == w.shape and torch.equal(g, w),
                    f"chunk_expand's {k} differs from its plain version "
                    f"(messy={messy})")
        del xp
        cap = fk.numel() // 16
        dk = md.qual_deltas(fk, x["qq"], cap)
        dp = md.qual_deltas_plain(fk, x["qq"], cap)
        require(int(dk[0]) == int(dp[0]) and torch.equal(dk[1], dp[1])
                and torch.equal(dk[2], dp[2]),
                f"qual_deltas differs from its plain version (messy={messy})")
        k6_checks.append({"messy": messy, "reads": C,
                          "chunk_expand_equal": True,
                          "changed_quals": int(dk[0]), "delta_cap": cap,
                          "qual_deltas_equal": True})
        emit({"phase": "chunk_kernels_check", **k6_checks[-1]})
        if not messy:
            k6 = _k6_rows(pipe, buf, x, fk, LQ)
            hmm_t = cuda_ms(lambda: bd.baq_hmm(*args))
            hmm_b2b = cuda_ms(lambda: bd.baq_hmm(*args), per=10)
            hmm_plain_t = cuda_ms(lambda: bd.baq_hmm_plain(*args))
            fin_t = cuda_ms(lambda: bd.baq_finalize(kq, kg, x["qq"],
                                                    x["seg"]))
            fin_b2b = cuda_ms(lambda: bd.baq_finalize(kq, kg, x["qq"],
                                                      x["seg"]), per=10)
            fin_plain_t = cuda_ms(lambda: bd.baq_finalize_plain(
                kq, kg, x["qq"], x["seg"]))
            # the kernels alone: a CUDA graph of wrapper calls (a wrapper
            # only allocates its outputs and launches; the graph replays
            # the launch)
            hmm_dev = graph_ms(lambda: bd.baq_hmm(*args), calls=10)
            fin_dev = graph_ms(lambda: bd.baq_finalize(kq, kg, x["qq"],
                                                       x["seg"]))
            k4_bytes = C * (LRM + LQ + LQ + 4 * LQ + 12) + C * (2 * LQ + 1)
            k4_ops = HMM_OPS_PER_CELL * 15 * LQ * C
            k5_bytes = C * LQ * (1 + 1 + 1 + 4 + 1)
            # K6, the whole chunk step on this clean chunk: the census
            # core's form, and the tool's (with the applied quals and
            # their sparse deltas)
            step = (buf, lo, hi, wbeg, ntp, 0, pipe.wlen)
            step_t = {
                "ms": cuda_ms(lambda: pipe._chunk_step(*step)),
                "b2b_ms": cuda_ms(lambda: pipe._chunk_step(*step), per=10),
                "tool_ms": cuda_ms(lambda: pipe._chunk_step(
                    *step, collect=True)),
                "tool_b2b_ms": cuda_ms(lambda: pipe._chunk_step(
                    *step, collect=True), per=10),
                # the device's time alone: a CUDA graph of chunk steps
                # (every wrapper only allocates and launches)
                "device_ms": graph_ms(lambda: pipe._chunk_step(*step),
                                      calls=5),
                "tool_device_ms": graph_ms(lambda: pipe._chunk_step(
                    *step, collect=True), calls=5), "reads": C}
    rows["baq_hmm"] = dict(max_abs_err=max(h["bq_max_abs_err"]
                                           for h in hmm_stats), ms=hmm_t,
                           b2b_ms=hmm_b2b, device_ms=hmm_dev,
                           plain_ms=hmm_plain_t, library_ms=None,
                           detail=hmm_stats,
                           **dict(zip(("bound_ms", "bound_by"),
                                      bound(k4_bytes, k4_ops))))
    rows["baq_finalize"] = dict(max_abs_err=fin_err, ms=fin_t,
                                b2b_ms=fin_b2b, device_ms=fin_dev,
                                plain_ms=fin_plain_t,
                                library_ms=None,
                                **dict(zip(("bound_ms", "bound_by"),
                                           bound(k5_bytes, 0))))

    # --- K1, both forms, on two chunks of 30x reads as the stream gives
    # them: one as it is, one with a deep pile (300 reads stacked at one
    # position make a tile slice of > 30,000 items).  Item slices start at
    # multiples of 100, so most lo are not 16-aligned.
    generic_before = kernels.launches["segment_contract"]
    k1 = []
    for chunk, pile in (("deep_pile", True), ("plain_30x", False)):
        b = simulate_batch(ref_len=sub_len, coverage=COVERAGE,
                           read_len=READ_LEN, seed=7, paired=False,
                           err_rate=0.01, ref=ref[:sub_len])
        if pile:
            mid = b.n // 2
            b.pos[mid:mid + 300] = b.pos[mid]
        pipe, x, lo, hi, wbeg, ntp, _ = chunk_inputs(b, ref_int, ref_len,
                                                     dev)
        kq, kg, kr = bd.baq_hmm(x["ref_win"], x["sq"], x["qq"], x["cdT"],
                                x["lref"], x["bMv"], x["bIv"], READ_LEN,
                                x["ref_win"].shape[1], 7)
        appq = bd.baq_finalize(kq, kg, x["qq"], x["seg"])
        # the census form's inputs, and the generic form's (rp, W) that
        # the chunk step built from them before the census form
        cargs = (x["refpos"], x["seg"], x["sq"], appq, kr, pipe.base, 0,
                 ref_len, pipe.min_baseq)
        rp, W = sk.census_weights(*cargs)
        width = int((hi - lo).max())
        require(width > 16384 if pile else width < 16384,
                f"K1 widest slice {width} ({chunk})")
        require(bool((lo % 16 != 0).any()), "K1 has no unaligned lo")
        plan = (lo, hi, wbeg, pipe.tile)
        out_k = torch.zeros(ntp * pipe.tile, 6, dtype=torch.int32,
                            device=dev)
        sk.segment_contract(rp, W, *plan, out_k)
        # the plain einsum is exact even under TF32 (0/1 and |W| <= 127
        # fit its 11-bit significand); still hold it to full f32 as K4's is
        require(not torch.backends.cuda.matmul.allow_tf32,
                "TF32 matmul is on before the K1 comparison")
        gen_err = int((out_k - sk.segment_contract_plain(rp, W, *plan))
                      .abs().max())
        out_c = torch.zeros_like(out_k)
        sk.segment_census(*cargs, *plan, out_c)
        cen_err = int((out_c - sk.segment_census_plain(*cargs, *plan))
                      .abs().max())
        require(gen_err == 0 and cen_err == 0,
                f"K1 differs from its plain version ({chunk}: generic "
                f"{gen_err}, census {cen_err})")
        # the generic form as one library call: index_add_ of the weights
        # of the items inside the plan's window
        inwin = (rp >= wbeg) & (rp < wbeg + ntp * pipe.tile)
        idx = (rp[inwin] - wbeg).long()
        W32 = W[inwin].int()
        out_l = torch.zeros_like(out_k)
        out_l.index_add_(0, idx, W32)
        require(bool((out_l == out_k).all()) and bool((out_c == out_k)
                                                      .all()),
                f"index_add_, K1 and its census form disagree ({chunk})")
        scratch = torch.zeros_like(out_k)
        n_items, n_reads = rp.numel(), kr.numel()
        lohi_out = 2 * lo.numel() * 4 + 2 * out_k.numel() * 4

        def gen():
            sk.segment_contract(rp, W, *plan, scratch)

        def cen():
            sk.segment_census(*cargs, *plan, scratch)

        def weights_then_gen():
            sk.segment_contract(*sk.census_weights(*cargs), *plan, scratch)

        k1.append(dict(
            kernel="segment_contract", chunk=chunk, max_abs_err=gen_err,
            ms=cuda_ms(gen), b2b_ms=cuda_ms(gen, per=10),
            device_ms=graph_ms(gen),
            plain_ms=cuda_ms(lambda: sk.segment_contract_plain(rp, W,
                                                               *plan)),
            library_ms=cuda_ms(lambda: scratch.index_add_(0, idx, W32)),
            detail={"items": n_items, "tiles": lo.numel(),
                    "widest_slice": width},
            **dict(zip(("bound_ms", "bound_by"),
                       bound(n_items * (4 + 6) + lohi_out, n_items * 6)))))
        k1.append(dict(
            kernel="segment_census", chunk=chunk, max_abs_err=cen_err,
            ms=cuda_ms(cen), b2b_ms=cuda_ms(cen, per=10),
            device_ms=graph_ms(cen),
            plain_ms=cuda_ms(lambda: sk.segment_census_plain(*cargs,
                                                             *plan)),
            # the same census by one library call: index_add_ of the
            # packed [items, 6] int32 census weights of the window's items
            library_ms=cuda_ms(lambda: scratch.index_add_(0, idx, W32)),
            weights_b2b_ms=cuda_ms(lambda: sk.census_weights(*cargs),
                                   per=10),
            weights_then_generic_b2b_ms=cuda_ms(weights_then_gen, per=10),
            detail={"items": n_items, "reads": n_reads, "tiles": lo.numel(),
                    "widest_slice": width},
            **dict(zip(("bound_ms", "bound_by"),
                       bound(n_items * 10 + n_reads + lohi_out,
                             n_items * 2)))))
    require(kernels.launches["segment_contract"] > generic_before,
            "the generic K1 never launched in the kernels phase")
    for r in k1:
        if r["chunk"] == "deep_pile":
            rows[r["kernel"]] = r
    for name, row in k6.items():
        rows[name] = dict(row, checks=k6_checks)
    # K6, the chunk step: the sum of its parts' bounds at this chunk (K4
    # by operations, the others by bytes)
    parts = ("baq_hmm", "baq_finalize", "segment_census", "chunk_expand",
             "qual_deltas")
    chunk_step = {"bound_ms": sum(rows[k]["bound_ms"] for k in parts),
                  "bound_by": "sum of K4, K5, K1 census-form, chunk_expand "
                              "and qual_deltas bounds", **step_t}
    emit({"phase": "kernels", **rows, "chunk_step": chunk_step,
          "k1_plain_30x": [r for r in k1 if r["chunk"] == "plain_30x"]})
    return rows


def oracle(path: str, ref_int: np.ndarray):
    """bench_baq_census over the inflated records, split at record
    boundaries over THREADS host threads (the function is per record, so
    the parts add up to the single-core result)."""
    from samtools_tpu_torch.io import bgzf, native
    from samtools_tpu_torch.io.bam import decode_header
    with open(path, "rb") as f:
        body = bgzf.decompress(f.read(), THREADS)
    _, off = decode_header(body)
    offs = native.bam_record_offsets(body, off)
    cuts = list(offs[np.linspace(0, offs.size, THREADS + 1)[:-1]
                     .astype(np.int64)]) + [body.size]
    with ThreadPoolExecutor(THREADS) as ex:
        parts = list(ex.map(
            lambda i: native.bench_baq_census(body[cuts[i]:cuts[i + 1]], 0,
                                              ref_int),
            range(THREADS)))
    census = sum(p[0].astype(np.int64) for p in parts)
    qsum = sum(p[1] for p in parts)
    return census, qsum, sum(p[2] for p in parts)


def write_front(src: str, dst: str) -> int:
    """The reads of ``src`` that start before FRONT_END, as the BAM
    ``dst`` under the same header: a shallower input on the same route.
    Returns their count."""
    from samtools_tpu_torch.io.bam import write_bam
    from samtools_tpu_torch.io.files import read_alignments
    got = read_alignments(src, THREADS)
    front = np.nonzero(got.batch.pos < FRONT_END)[0]
    write_bam(dst, got.header, got.batch.take(front), threads=THREADS)
    return int(front.size)


def write_fasta(path: str, ref: np.ndarray) -> None:
    """``ref`` as a FASTA of 60-column lines, with its .fai."""
    with open(path, "wb") as f:
        f.write(b">sim1\n")
        f.write(b"".join(ref[i:i + 60].tobytes() + b"\n"
                         for i in range(0, ref.size, 60)))
    with open(path + ".fai", "w") as f:
        f.write(f"sim1\t{ref.size}\t6\t60\t61\n")


# clean's and messy's reads simulated and written as a BAM, each in a
# process of its own, the two at once (no card work runs meanwhile); the
# reference is simulate_reference(REF_LEN, seed=7), as main()'s
SIM_CHILD = r"""
import sys
from samtools_tpu_torch.io.bam import write_bam
from samtools_tpu_torch.sim import (make_header, simulate_batch,
                                    simulate_messy, simulate_reference)
path, seed, messy, ref_len, coverage, read_len, threads = sys.argv[1:]
ref_len, seed, threads = int(ref_len), int(seed), int(threads)
b = simulate_batch(ref_len=ref_len, coverage=float(coverage),
                   read_len=int(read_len), seed=seed, paired=False,
                   err_rate=0.01, ref=simulate_reference(ref_len, seed=7))
if messy == "1":
    simulate_messy(b, seed)
write_bam(path, make_header(ref_len), b, threads=threads)
"""


def simulate_main_bams(workdir: str) -> dict:
    """clean.bam (seed 42) and messy.bam (seed 9, ``simulate_messy``) in
    ``workdir``, SIM_CHILD processes at once; name -> (path, wall)."""
    procs = {}
    t0 = time.perf_counter()
    for name, seed in (("clean", 42), ("messy", 9)):
        path = os.path.join(workdir, f"{name}.bam")
        procs[name] = (path, subprocess.Popen(
            [sys.executable, "-c", SIM_CHILD, path, str(seed),
             "1" if name == "messy" else "0", str(REF_LEN), str(COVERAGE),
             str(READ_LEN), str(max(1, THREADS // 2))], cwd=ROOT,
            stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
            stderr=subprocess.PIPE))
    out = {}
    for name, (path, p) in procs.items():
        _, err = p.communicate(timeout=600)
        require(p.returncode == 0, f"simulating {name}: rc {p.returncode}: "
                f"{err.decode()[-500:]}")
        out[name] = (path, time.perf_counter() - t0)
    return out


def phase_main(ref: np.ndarray, ref_int: np.ndarray, workdir: str):
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.io.stream import BamStream
    from samtools_tpu_torch.ops.mpileup_device import (DeviceCensusPipeline,
                                                       census_checksum)
    import torch
    launches, oracles = {}, {}
    sims = simulate_main_bams(workdir)
    for name in ("clean", "messy"):
        path, t_sim = sims[name]
        kernels.reset_launches()
        t0 = time.perf_counter()
        pipe = DeviceCensusPipeline(ref_int, REF_LEN)
        with BamStream(path, threads=THREADS, window_bytes=64 << 20) as st:
            for batch in st.batches():
                pipe.add_batch(batch)
        pipe._flush()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        census, qsum = pipe.finish()
        torch.cuda.synchronize()
        t_core = time.perf_counter() - t0
        t_finish = time.perf_counter() - t1
        ck = pipe.finish_checksum()
        runs = dict(kernels.launches)
        # the finish() K7n replaced: the int32 census fetched as it is,
        # widened, the host part added
        t1 = time.perf_counter()
        c = pipe.census_dev[:pipe.wlen].cpu().numpy().astype(np.int64)
        wide = (c[:, :5] + pipe.host_census, c[:, 5] + pipe.host_qsum)
        t_wide = time.perf_counter() - t1
        require(np.array_equal(wide[0], census) and np.array_equal(
            wide[1], qsum), f"{name}: finish() differs from the int32 fetch")
        del c, wide
        if name == "clean":
            core_census = pipe.census_dev

        t0 = time.perf_counter()
        o_census, o_qsum, nrec = oracle(path, ref_int)
        t_oracle = time.perf_counter() - t0
        require(pipe.n_reads == nrec, f"{name}: {pipe.n_reads} reads, "
                f"oracle {nrec}")
        require(np.array_equal(census, o_census), f"{name}: census differs")
        require(np.array_equal(qsum, o_qsum), f"{name}: qual sums differ")
        require(ck == census_checksum(o_census, o_qsum),
                f"{name}: checksum differs")
        require(all(runs[k] > 0 for k in MAIN_PATH) and
                runs["segment_contract"] == 0,
                f"{name}: the main path's kernels are {MAIN_PATH}: {runs}")
        require(runs["census_narrow"] == 1,
                f"{name}: finish() launched K7n {runs['census_narrow']} "
                "times, not once")
        launches[name] = runs
        oracles[name] = (path, o_census, o_qsum, nrec)
        emit({"phase": "main_path", "workload": name,
              "reads": int(nrec), "simulate_write_s": round(t_sim, 3),
              "stream_device_s": round(t_core, 3),
              "Mbases_per_s": round(nrec * READ_LEN / t_core / 1e6, 3),
              "host_reads": int(pipe.n_host_reads),
              "risky_reads": int(pipe.n_risky),
              "oracle_s_threads": [round(t_oracle, 3), THREADS],
              "finish_s": round(t_finish, 4),
              "int32_finish_s": round(t_wide, 4),
              "launches": runs, "census_equal": True, "checksum": list(ck)})
    return launches, oracles, core_census


def count_rows(path: str) -> int:
    rows = 0
    with open(path, "rb") as f:
        while chunk := f.read(1 << 24):
            rows += chunk.count(b"\n")
    return rows


def phase_tool(ref: np.ndarray, workdir: str, oracles: dict) -> dict:
    """The mpileup command on the card: in-process on the 8 Mbp BAMs, then
    as a subprocess, card engine against host engine, on overlapping
    pairs."""
    import torch
    from samtools_tpu_torch import cli, kernels
    from samtools_tpu_torch.io.bam import write_bam
    from samtools_tpu_torch.ops.mpileup_device import census_checksum
    from samtools_tpu_torch.sim import (make_header,
                                        simulate_overlapping_pairs)
    fa = os.path.join(workdir, "ref.fa")
    write_fasta(fa, ref)
    launches, texts = {}, {}
    for name, (bam, o_census, o_qsum, nrec) in oracles.items():
        out = os.path.join(workdir, f"{name}.pileup")
        cj = os.path.join(workdir, f"{name}.census.json")
        kernels.reset_launches()
        t0 = time.perf_counter()
        rc = cli.main(["mpileup", "-f", fa, bam, "-o", out, "--census-out",
                       cj])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs = dict(kernels.launches)
        require(rc == 0, f"tool {name}: rc {rc}")
        with open(cj) as f:
            rec = json.load(f)
        for w in rec["windows"]:
            require(tuple(w["checksum"]) == census_checksum(
                o_census[w["beg"]:w["end"]], o_qsum[w["beg"]:w["end"]]),
                f"tool {name}: census of window {w['beg']} differs")
        starting = sum(w["reads_starting"] for w in rec["windows"])
        require(starting == nrec, f"tool {name}: windows start {starting} "
                f"reads, oracle {nrec}")
        require(all(runs[k] > 0 for k in MAIN_PATH) and
                runs["segment_contract"] == 0,
                f"tool {name}: the main path's kernels are {MAIN_PATH}: "
                f"{runs}")
        # K7 once a device window's --census-out checksum; K6's front and
        # tail once a device chunk (each chunk launches K1's census form
        # once)
        require(runs["census_checksum"] == rec["device_windows"] > 0,
                f"tool {name}: K7 launched {runs['census_checksum']} times "
                f"for {rec['device_windows']} device windows")
        require(runs["chunk_expand"] == runs["qual_deltas"]
                == runs["segment_census"],
                f"tool {name}: chunk_expand {runs['chunk_expand']} and "
                f"qual_deltas {runs['qual_deltas']} launches for "
                f"{runs['segment_census']} device chunks")
        launches[name] = runs
        texts[name] = out
        emit({"phase": "tool", "workload": name, "reads": int(nrec),
              "wall_s": round(wall, 3),
              "Mbases_per_s": round(nrec * READ_LEN / wall / 1e6, 3),
              "output_bytes": os.path.getsize(out),
              "output_rows": count_rows(out),
              "windows": len(rec["windows"]),
              "device_windows": rec["device_windows"],
              "window_reads": rec["reads"],
              "host_reads": rec["host_reads"],
              "risky_reads": sum(w.get("risky_reads", 0)
                                 for w in rec["windows"]),
              "device_chunks": runs["segment_census"],
              "launches": runs, "census_equal": True})
        if name != "clean":
            os.remove(out)

    # the command as a user runs it: card engine against host engine
    t0 = time.perf_counter()
    pair_len = 1 << 19
    b = simulate_overlapping_pairs(pair_len, coverage=COVERAGE,
                                   read_len=READ_LEN, seed=17,
                                   ref=ref[:pair_len])
    bam = os.path.join(workdir, "pairs.bam")
    write_bam(bam, make_header(ref.size), b, threads=THREADS)
    n_pairs_reads = b.n
    del b
    t_sim = time.perf_counter() - t0
    outs, walls = {}, {}
    for engine in ("card", "host"):
        env = dict(os.environ)
        env.pop("SAMTPU_DEVICE", None)
        if engine == "host":
            env["SAMTPU_DEVICE"] = "0"
        outs[engine] = os.path.join(workdir, f"pairs.{engine}.pileup")
        t0 = time.perf_counter()
        p = subprocess.run([sys.executable, "-m", "samtools_tpu_torch",
                            "mpileup", "-f", fa, bam, "-o", outs[engine]],
                           env=env, capture_output=True, text=True,
                           timeout=600)
        walls[engine] = time.perf_counter() - t0
        require(p.returncode == 0, f"pairs ({engine}): rc {p.returncode}: "
                f"{p.stderr[-2000:]}")
    with open(outs["card"], "rb") as f:
        card = f.read()
    with open(outs["host"], "rb") as f:
        host = f.read()
    require(card == host, "pairs: the card engine's output differs from "
            "the host engine's")
    require(card.count(b"\n") > pair_len // 2, "pairs: too few rows")
    emit({"phase": "tool_pairs", "reads": int(n_pairs_reads),
          "simulate_write_s": round(t_sim, 3),
          "card_wall_s": round(walls["card"], 3),
          "host_wall_s": round(walls["host"], 3),
          "output_bytes": len(card), "output_rows": card.count(b"\n"),
          "byte_equal": True})
    return launches, (bam, n_pairs_reads), texts["clean"]


def global_share(rp, lo, hi, wbeg: int, tile: int, P: int, win: int):
    """The share of K1's live items that take its global-atomic path:
    each piece of P items accumulates rows [rmin, rmin + win) in shared
    memory, rmin its least live row; a live item at a row past that goes
    to global atomics (csrc/segment_contract.cu, steps 2-3)."""
    import torch
    n_tiles = lo.numel()
    b = torch.arange(rp.numel(), device=rp.device)
    r = rp.long() - wbeg
    t = r.clamp(0, n_tiles * tile - 1) // tile
    live = (r >= 0) & (r < n_tiles * tile) & (b >= lo[t]) & (b < hi[t])
    piece = b // P
    rmin = torch.full(((rp.numel() + P - 1) // P,), 1 << 62,
                      dtype=torch.int64, device=rp.device)
    rmin.scatter_reduce_(0, piece[live], r[live], "amin")
    glob = live & (r - rmin[piece] >= win)
    return int(glob.sum()) / max(1, int(live.sum()))


def phase_kernels_pileup(clean: str, dev) -> tuple:
    """K1's generic form and K9's two kernels at the pileup family's
    shapes, on the clean BAM; also the reads of the coverage -r run."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.io.files import read_alignments
    from samtools_tpu_torch.ops import pileup_engine as pe
    from samtools_tpu_torch.ops import segment_kernel as sk
    b = read_alignments(clean, THREADS).batch
    sel = np.arange(b.n)
    wbeg, wend = int(b.pos.min()), int(b.end_pos().max())
    # depth's difference events over the whole contig (one window); the
    # coverage items of the first streamed window of 1 Mi columns
    shapes = {"depth": pe.depth_items(b, sel, wbeg, wend, 0, False)[0],
              "coverage": pe.coverage_items(b, sel[b.pos < 1 << 20], 0,
                                            1 << 20, 0)}
    region_reads = int((b.pos < REGION_END).sum())
    del b, sel
    rows, outs = {}, {}
    before = kernels.launches["segment_contract"]
    for shape, (pos, W, plan) in shapes.items():
        K = W.shape[1]
        rp = torch.from_numpy(pos.astype(np.int32)).to(dev)
        Wt = torch.from_numpy(W).to(dev)
        lo = torch.from_numpy(plan.lo).to(dev)
        hi = torch.from_numpy(plan.hi).to(dev)
        args = (rp, Wt, lo, hi, plan.wbeg, plan.tile)
        n_rows = plan.n_tiles * plan.tile
        out_k = torch.zeros(n_rows, K, dtype=torch.int32, device=dev)
        sk.segment_contract(*args, out_k)
        err = int((out_k - sk.segment_contract_plain(*args)).abs().max())
        inwin = (rp >= plan.wbeg) & (rp < plan.wbeg + n_rows)
        idx = (rp[inwin] - plan.wbeg).long()
        W32 = Wt[inwin].int()
        out_l = torch.zeros_like(out_k)
        out_l.index_add_(0, idx, W32)
        require(err == 0 and bool((out_l == out_k).all()),
                f"K1 at the {shape} shape differs from its plain version "
                f"({err}) or from index_add_")
        scratch = torch.zeros_like(out_k)
        P, win = sk.piece_layout(4 + K, K)
        n = rp.numel()
        rows[shape] = dict(
            kernel="segment_contract", max_abs_err=err,
            ms=cuda_ms(lambda: sk.segment_contract(*args, scratch)),
            b2b_ms=cuda_ms(lambda: sk.segment_contract(*args, scratch),
                           per=10),
            plain_ms=cuda_ms(lambda: sk.segment_contract_plain(*args),
                             reps=3),
            library_ms=cuda_ms(lambda: scratch.index_add_(0, idx, W32)),
            global_atomic_share=global_share(rp, lo, hi, plan.wbeg,
                                             plan.tile, P, win),
            detail={"items": n, "K": K, "tile": plan.tile,
                    "tiles": plan.n_tiles, "piece_items": P,
                    "acc_rows": win,
                    "widest_slice": int((plan.hi - plan.lo).max())},
            **dict(zip(("bound_ms", "bound_by"),
                       bound(n * (4 + K) + 2 * plan.n_tiles * 4
                             + n_rows * K * 4, n * K))))
        outs[shape] = out_k
    require(kernels.launches["segment_contract"] > before,
            "the generic K1 never launched at the pileup shapes")
    # K9: the depth scan (csrc/depth_scan.cu: the scan and the max, the
    # first L values as int32 into pinned host memory) on the depth
    # column (no direct column: the default depth has none) and the
    # coverage gate
    # and subwindow sums (csrc/cov_reduce.cu) on the coverage census,
    # each equal to its plain version, then at their edges
    d_out = outs["depth"]
    L = wend - wbeg
    depth = pe.depth_scan(d_out, None, L)
    require(depth.shape == (L,) and int(depth.min()) >= 0
            and 20 < int(depth.max()) < 256, "depth scan: bad depths")
    c_out = outs["coverage"]
    red = pe.cov_reduce(c_out, 1 << 16, 1)
    require(int(red[:, 2].sum()) > 0.99 * (1 << 20),
            "coverage reduction: too few covered positions")
    rows["depth_scan"] = ad().depth_row(d_out, None, L)
    rows["depth_scan"]["edges"] = ad().depth_edges(dev)
    rows["cov_reduce"] = ad().cov_row(c_out, 1 << 16, 1)
    rows["cov_reduce"]["edges"] = ad().cov_edges(dev)
    emit({"phase": "kernels_pileup", **rows})
    return rows, region_reads


def bed_intervals(path: str, span: int, n: int = 1000) -> None:
    """n BED intervals of 1-10 kbp on sim1's first ``span`` bases,
    seeded."""
    rng = np.random.default_rng(21)
    starts = np.sort(rng.integers(0, span - 10_000, n))
    lens = rng.integers(1_000, 10_001, n)
    with open(path, "w") as f:
        for i, (s0, ln) in enumerate(zip(starts, lens)):
            f.write(f"sim1\t{s0}\t{s0 + ln}\tr{i}\n")


# a command through cli.main as ``python -m samtools_tpu_torch`` runs it
# (standard input passed on), the launches of its kernels printed last on
# standard error
LAUNCH_CHILD = r"""
import json, sys
from samtools_tpu_torch import cli, kernels
rc = cli.main(sys.argv[1:])
sys.stdout.flush()
print(json.dumps({k: v for k, v in kernels.launches.items() if v}),
      file=sys.stderr)
sys.exit(rc)
"""


def phase_pileup_family(workdir: str, bams: dict, reads: dict) -> dict:
    """depth, coverage and bedcov on the card against SAMTPU_DEVICE=0;
    each card run's launches (bedcov's from its process)."""
    import filecmp

    launches = {}
    runs = [(f"{label} {wl}", [a.format(**bams) for a in argv], "-o", True)
            for label, argv, wl in PILEUP_RUNS]
    for (label, argv, wl), (_, (wall, card, out), (host, host_out)) in zip(
            PILEUP_RUNS, card_and_host(runs, workdir, "pileup")):
        require(filecmp.cmp(out, host_out, shallow=False),
                f"{label} on {wl}: the card's output differs from the "
                "host branch's")
        # depth: K1 and a depth scan a window; coverage: K1 and a
        # coverage reduction a window (one file: a K1 launch a window)
        k9 = "cov_reduce" if argv[0] == "coverage" else "depth_scan"
        require(card["segment_contract"] > 0 and card[k9] > 0
                and {k for k, v in card.items() if v} == {
                    "segment_contract", k9}
                and (k9 == "depth_scan"
                     or card["cov_reduce"] == card["segment_contract"]),
                f"{label} on {wl}: the card run launched {card}")
        rows = count_rows(out)
        require(rows > 1, f"{label} on {wl}: no rows")
        n = reads["region" if "-r" in argv else wl]
        emit({"phase": "pileup_family", "run": label, "workload": wl,
              "reads": int(n), "card_wall_s": round(wall, 3),
              "host_wall_s": round(host["wall_s"], 3),
              "host_process_wall_s": round(host["process_wall_s"], 3),
              "Mbases_per_s": round(n * READ_LEN / wall / 1e6, 3),
              "output_bytes": os.path.getsize(out), "output_rows": rows,
              "launches": card, "byte_equal": True})
        launches[f"{label} {wl}"] = card
        os.remove(out)
        os.remove(host_out)

    # bedcov as a user runs it: the BAM on standard input
    bed = os.path.join(workdir, "regions.bed")
    bed_intervals(bed, FRONT_END)
    got, walls = {}, {}

    def bedcov(engine):
        env = dict(os.environ)
        env.pop("SAMTPU_DEVICE", None)
        if engine == "host":
            env["SAMTPU_DEVICE"] = "0"
        t0 = time.perf_counter()
        with open(bams["clean_front"], "rb") as fin:
            p = subprocess.run([sys.executable, "-c", LAUNCH_CHILD, "bedcov",
                                "-c", bed, "-"], stdin=fin, env=env,
                               cwd=ROOT, capture_output=True, timeout=600)
        walls[engine] = time.perf_counter() - t0
        require(p.returncode == 0, f"bedcov ({engine}): rc {p.returncode}: "
                f"{p.stderr.decode()[-2000:]}")
        got[engine] = p.stdout
        counts[engine] = json.loads(p.stderr.decode().splitlines()[-1])
    counts = {}
    # the card's process and the host branch's at once
    with ThreadPoolExecutor(2) as ex:
        for f in [ex.submit(bedcov, e) for e in ("card", "host")]:
            f.result()
    require(not counts["host"] and counts["card"].get("depth_scan", 0) > 0
            and set(counts["card"]) == {"segment_contract", "depth_scan"},
            f"bedcov: the card's process launched {counts['card']}, the "
            f"host branch's {counts['host']}")
    require(got["card"] == got["host"], "bedcov: the card's output differs "
            "from the host branch's")
    require(got["card"].count(b"\n") == 1000, "bedcov: not 1,000 rows")
    launches["bedcov -c (stdin) clean_front"] = counts["card"]
    emit({"phase": "pileup_family", "run": "bedcov -c (stdin)",
          "workload": "clean_front", "reads": int(reads["clean_front"]),
          "launches": counts["card"],
          "card_wall_s": round(walls["card"], 3),
          "host_wall_s": round(walls["host"], 3),
          "Mbases_per_s": round(reads["clean_front"] * READ_LEN
                                / walls["card"] / 1e6, 3),
          "output_bytes": len(got["card"]),
          "output_rows": got["card"].count(b"\n"), "byte_equal": True})
    return launches


def strip_extra_columns(path: str, want_path: str, n: int,
                        end: int) -> int:
    """Rows of ``path`` up to position ``end``, without their last ``n``
    columns, must equal the rows of ``want_path`` up to that position, in
    order: returns the row count compared."""
    rows = 0
    with open(path, "rb") as f, open(want_path, "rb") as g:
        for a in f:
            if int(a.split(b"\t", 2)[1]) > end:
                break
            b = g.readline()
            require(a.rsplit(b"\t", n)[0] + b"\n" == b,
                    f"general: row {rows} differs from the fast branch's")
            rows += 1
        nxt = g.readline()
        require(not nxt or int(nxt.split(b"\t", 2)[1]) > end,
                "general: row counts differ from the fast branch's")
    return rows


def phase_general(ref: np.ndarray, ref_int: np.ndarray, workdir: str,
                  bams: dict, clean_text: str, dev) -> tuple:
    """K8, its front and K13 against their plain versions at main-path
    shapes, then
    mpileup's general path and coverage -m as a user runs them; also the
    messy reads that start in the region."""
    import filecmp

    import torch
    from samtools_tpu_torch.io import native
    from samtools_tpu_torch.io.files import read_alignments
    from samtools_tpu_torch.ops import baq
    from samtools_tpu_torch.ops import baq_device as bd
    from samtools_tpu_torch.ops import pileup
    from samtools_tpu_torch.ops.cigar import expand_ops
    from samtools_tpu_torch.core.batch import ragged_gather_indices
    rows = {}
    # the reads each general run takes: all of clean, or those starting
    # in the region (two files for the second run)
    counts = {}
    for name in ("messy", "pairs"):
        m = read_alignments(bams[name], THREADS).batch
        counts[f"{name}_region2"] = int((m.pos < FASTQ_END).sum())
        counts["region2"] = counts.get("region2", 0) + int(
            (m.pos < GENERAL2_END).sum())
        del m
    b = read_alignments(bams["clean"], THREADS).batch
    counts["clean"] = b.n
    counts["region"] = int((b.pos < REGION_END).sum())
    counts["clean_region2"] = int((b.pos < REGION2_END).sum())
    counts["clean_front"] = int((b.pos < FRONT_END).sum())
    n_windows = -(-(FRONT_END + READ_LEN) // (1 << 20))

    # --- K8 on a group of CHUNK all-M reads of 100 bases (one chunk)
    k = np.nonzero((b.n_cigar == 1) & (b.l_qseq == READ_LEN))[0][:CHUNK]
    group = b.take(k)
    idx = group.seq_off[:-1][:, None] + np.arange(READ_LEN)[None, :]
    pos, seq, qual = group.pos.astype(np.int64), group.seq[idx], \
        group.qual[idx]
    ref_dev = torch.from_numpy(ref_int).to(dev)
    buf = np.empty((k.size, 4 + 2 * READ_LEN), np.uint8)
    buf[:, :4] = pos.astype("<i4").view(np.uint8).reshape(-1, 4)
    buf[:, 4:4 + READ_LEN] = seq
    buf[:, 4 + READ_LEN:] = qual
    buf_dev = torch.from_numpy(buf).to(dev)
    kq, kr = bd.baq_apply(ref_dev, buf_dev)
    pq, pr = bd.baq_apply_plain(ref_dev, buf_dev)
    torch.cuda.synchronize()
    both_ok = ~(kr | pr)
    symdiff = int((kr ^ pr).sum())
    k8_err = int((kq[both_ok].int() - pq[both_ok].int()).abs().max())
    require(k8_err == 0, "K8: applied quals differ on non-risky reads")
    require(symdiff <= 0.01 * k.size,
            f"K8: risky sets differ on {symdiff} of {k.size} reads")
    # after the host recompute of the risky reads: the host HMM's bytes
    t0 = time.perf_counter()
    want, _ = native.baq_batch(group.pos, group.cigar, group.cigar_off,
                               group.seq, group.qual, group.seq_off, ref_int,
                               flag=3, threads=THREADS)
    host_ms = (time.perf_counter() - t0) * 1e3
    applied = group.take(np.arange(group.n))
    baq.apply_baq_batch(applied, ref_int, device=dev, ref_dev=ref_dev)
    require(np.array_equal(applied.qual, want),
            "K8 + host recompute differs from io.native.baq_batch")
    C, LQ = k.size, READ_LEN
    l_ref = LQ + bd.APPLY_PAD
    k4_ops = HMM_OPS_PER_CELL * 15 * LQ * C
    k8_bytes = C * (4 + 2 * LQ) + C * l_ref + C * (LQ + 1)
    # K8's front alone, and K8 on the card as a CUDA graph of its three
    # bare entries (the front, K4, K5)
    front = ad().apply_rows(ref_dev, buf_dev)
    rows["apply_expand"] = front["apply_expand"]
    rows["baq_apply"] = dict(
        max_abs_err=k8_err,
        ms=cuda_ms(lambda: bd.baq_apply(ref_dev, buf_dev)),
        b2b_ms=cuda_ms(lambda: bd.baq_apply(ref_dev, buf_dev), per=10),
        device_ms=front["baq_apply_device_ms"],
        plain_ms=cuda_ms(lambda: bd.baq_apply_plain(ref_dev, buf_dev),
                         reps=3),
        library_ms=None, host_baq_batch_ms=host_ms,
        host_baq_batch_threads=THREADS,
        bound_sum_k4_ops_k5_bytes_ms=(
            k4_ops / F32_OPS_PER_S + C * LQ * 8 / HBM_BYTES_PER_S) * 1e3,
        detail={"reads": C, "risky_kernel": int(kr.sum()),
                "risky_plain": int(pr.sum()), "risky_symdiff": symdiff,
                "quals_equal_host_hmm": True},
        **dict(zip(("bound_ms", "bound_by"), bound(k8_bytes, k4_ops))))
    del group, applied, buf_dev

    # --- K13 on the entry positions of the clean BAM's first 1 Mi window
    sub = b.take(np.nonzero(b.pos < 1 << 20)[0], ragged=("cigar",))
    del b
    t = expand_ops(sub)
    emit_ops = np.isin(t.op, (0, 2, 3, 7, 8))
    epos = ragged_gather_indices(t.rpos[emit_ops], t.oplen[emit_ops])
    keys = (epos - epos.min()).astype(np.int32)
    del sub, t, epos
    keys_dev = torch.from_numpy(keys).to(dev)
    t0 = time.perf_counter()
    want = np.argsort(keys, kind="stable")
    host_sort_ms = (time.perf_counter() - t0) * 1e3
    got = pileup.stable_order(keys_dev)
    require(np.array_equal(got.cpu().numpy(), want),
            "K13 differs from np.argsort(kind='stable')")
    del want, got
    n = keys.size
    rows["stable_order"] = dict(
        max_abs_err=0,
        ms=cuda_ms(lambda: pileup.stable_order(keys_dev)),
        b2b_ms=cuda_ms(lambda: pileup.stable_order(keys_dev), per=10),
        plain_ms=host_sort_ms, host_argsort_ms=host_sort_ms,
        library_ms=cuda_ms(lambda: torch.argsort(keys_dev, stable=True)),
        detail={"entries": int(n)},
        **dict(zip(("bound_ms", "bound_by"), bound(n * (4 + 8), 0))))
    del keys_dev
    emit({"phase": "kernels_general", **rows})

    # --- the general path as a user runs it
    fa = os.path.join(workdir, "ref.fa")
    launches = {}
    runs = [(label, [a.format(fa=fa, **bams) for a in argv], "-o",
             "host" in engines) for label, argv, _, engines in GENERAL_RUNS]
    for (label, argv, wl, _), (_, (wall, card, out), host) in zip(
            GENERAL_RUNS, card_and_host(runs, workdir, "general")):
        outs, walls = {"card": out}, {"card": wall}
        is_mpileup = argv[0] == "mpileup"
        require(card["stable_order"] > 0 and card["segment_census"] == 0
                and card["segment_contract"] == 0
                and (card["baq_apply"] > 0) == is_mpileup
                and card["apply_expand"] == card["baq_apply"]
                and (card["baq_hmm"] > 0) == is_mpileup
                and (card["baq_finalize"] > 0) == is_mpileup,
                f"{label}: the card run launched {card}")
        if wl == "clean_front":
            # the streamed windows each build their table and apply BAQ
            require(card["stable_order"] >= n_windows
                    and card["baq_apply"] >= n_windows,
                    f"{label}: {card} over {n_windows} stream windows")
        if host is not None:
            walls["host"] = host[0]["wall_s"]
            walls["host_process"] = host[0]["process_wall_s"]
            outs["host"] = host[1]
            require(filecmp.cmp(outs["card"], outs["host"], shallow=False),
                    f"{label}: the card's output differs from the host "
                    "branch's")
            n_rows = count_rows(outs["card"])
        else:
            # -s -O: without its two extra columns, the fast branch's rows
            n_rows = strip_extra_columns(outs["card"], clean_text, 2,
                                         FRONT_END)
        require(n_rows > (1000 if is_mpileup else 10),
                f"{label}: too few rows")
        n = counts[wl]
        emit({"phase": "general", "run": label, "reads": int(n),
              **{f"{e}_wall_s": round(w, 3) for e, w in walls.items()},
              "Mbases_per_s": round(n * READ_LEN / walls["card"] / 1e6, 3),
              "output_bytes": os.path.getsize(outs["card"]),
              "output_rows": n_rows, "launches": card,
              "byte_equal": True})
        launches[label] = card
        for p in outs.values():
            os.remove(p)
    return rows, launches, counts


# consensus and flagstat in-process, card against SAMTPU_DEVICE=0: (label,
# argv, reads counted, output: "-o" or standard output)
CONSENSUS_RUNS = (
    ("consensus -r", ["consensus", "-r", "sim1:1-1000000", "{clean}"],
     "clean_region2", "-o"),
    ("consensus -a --show-ins --show-del -f fastq -r",
     ["consensus", "-a", "--show-ins", "yes", "--show-del", "yes", "-f",
      "fastq", "-r", f"sim1:1-{FASTQ_END}", "{messy}"], "messy_region2",
     "-o"),
    ("flagstat", ["flagstat", "{clean}"], "clean", "stdout"),
    ("flagstat -O json", ["flagstat", "-O", "json", "{pairs}"], "pairs",
     "stdout"),
)


def run_cli(argv: list[str], out: str, to: str, host: bool) -> float:
    """One in-process run of the port's command, its output in ``out``
    (``-o``, or standard output redirected there), on the card or the
    host branch; its wall."""
    import contextlib

    import torch
    from samtools_tpu_torch import cli
    saved = os.environ.pop("SAMTPU_DEVICE", None)
    if host:
        os.environ["SAMTPU_DEVICE"] = "0"
    t0 = time.perf_counter()
    try:
        if to == "-o":
            rc = cli.main([*argv, "-o", out])
        else:
            with open(out, "w") as f, contextlib.redirect_stdout(f):
                rc = cli.main(argv)
        torch.cuda.synchronize()
    finally:
        os.environ.pop("SAMTPU_DEVICE", None)
        if saved is not None:
            os.environ["SAMTPU_DEVICE"] = saved
    require(rc == 0, f"{' '.join(argv[:3])}: rc {rc}")
    return time.perf_counter() - t0


# host-branch twins run as processes, this many at a time beside the
# card's in-process runs (the phases that hold the card to SAMTPU_DEVICE=0)
HOST_TWINS = 2

# one host-branch twin: the command through cli.main, its output to a
# file by -o or standard output; a JSON report of its exit code, its wall
# (cli.main's, as an in-process run's), its launches and whether it made
# a CUDA context
HOST_CHILD = r"""
import contextlib, json, sys, time
import torch
from samtools_tpu_torch import cli, kernels
report, spec = sys.argv[1], json.loads(sys.argv[2])
t0 = time.perf_counter()
if spec["to"] == "-o":
    rc = cli.main([*spec["argv"], "-o", spec["out"]])
else:
    with open(spec["out"], "w") as f, contextlib.redirect_stdout(f):
        rc = cli.main(spec["argv"])
res = {"rc": rc, "wall_s": time.perf_counter() - t0,
       "launches": {k: v for k, v in kernels.launches.items() if v},
       "cuda_initialized": torch.cuda.is_initialized()}
with open(report, "w") as f:
    json.dump(res, f)
"""


def host_twin(argv: list[str], out: str, to: str) -> dict:
    """``argv`` on the host branch (SAMTPU_DEVICE=0) as a HOST_CHILD
    process, its output in ``out``; its report, with the process's wall
    from spawn (``process_wall_s``).  Raises unless it exits 0, launches
    no kernel and makes no CUDA context."""
    report = out + ".json"
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-c", HOST_CHILD, report,
                        json.dumps({"argv": argv, "out": out, "to": to})],
                       env=dict(os.environ, SAMTPU_DEVICE="0"), cwd=ROOT,
                       stdin=subprocess.DEVNULL, stdout=subprocess.DEVNULL,
                       stderr=subprocess.PIPE, timeout=900)
    wall = time.perf_counter() - t0
    what = " ".join(argv[:3]) + " (host branch)"
    require(p.returncode == 0 and os.path.exists(report),
            f"{what}: process rc {p.returncode}: "
            f"{p.stderr.decode()[-500:]}")
    with open(report) as f:
        res = json.load(f)
    os.remove(report)
    require(res["rc"] == 0, f"{what}: rc {res['rc']}")
    require(not res["launches"] and not res["cuda_initialized"],
            f"{what}: launched {res['launches']}, CUDA context "
            f"{res['cuda_initialized']}")
    res["process_wall_s"] = wall
    return res


def card_and_host(runs, workdir: str, name: str):
    """Each of ``runs`` ((label, argv, output: "-o" or "stdout", whether
    the host branch runs too)) in-process on the card, and where asked
    its host twin (``host_twin``, HOST_TWINS at a time, all started
    first).  Yields in order (label, card run: (wall, launches, output),
    host twin: (report, output) or None); the caller removes the
    outputs."""
    from samtools_tpu_torch import kernels
    ex = ThreadPoolExecutor(HOST_TWINS)
    try:
        host = {}
        for i, (_, argv, to, twin) in enumerate(runs):
            if twin:
                out = os.path.join(workdir, f"{name}{i}.host")
                host[i] = (ex.submit(host_twin, argv, out, to), out)
        for i, (label, argv, to, twin) in enumerate(runs):
            out = os.path.join(workdir, f"{name}{i}.card")
            kernels.reset_launches()
            wall = run_cli(argv, out, to, False)
            yield (label, (wall, dict(kernels.launches), out),
                   (host[i][0].result(), host[i][1]) if twin else None)
    finally:
        ex.shutdown(wait=True, cancel_futures=True)


def phase_consensus(workdir: str, bams: dict, clean_text: str,
                    counts: dict, dev) -> tuple:
    """consensus, flagstat and mpileup --checkpoint as a user runs them,
    then K10 and K11 against their plain versions at those runs' shapes."""
    import filecmp

    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.io.files import read_alignments
    from samtools_tpu_torch.io.stream import BamStream
    from samtools_tpu_torch.ops import consensus_vec as cv
    rows, launches, whole_runs = {}, {}, {}
    # the entries of the first window K10 scores (clean's first 1 Mi
    # columns), kept from the first card run
    first = []
    scorer = cv.gap5_scores_device

    def keep_first(*args):
        if not first:
            first.append(args)
        return scorer(*args)
    runs = [(label, [a.format(**bams) for a in argv], to, True)
            for label, argv, _, to in CONSENSUS_RUNS]
    cv.gap5_scores_device = keep_first
    try:
        done = list(card_and_host(runs, workdir, "cons"))
    finally:
        cv.gap5_scores_device = scorer
    for (label, argv, wl, _), (_, (wall, card, out), (host, host_out)) in \
            zip(CONSENSUS_RUNS, done):
        outs = {"card": out, "host": host_out}
        walls = {"card": wall, "host": host["wall_s"],
                 "host_process": host["process_wall_s"]}
        require(filecmp.cmp(outs["card"], outs["host"], shallow=False),
                f"{label}: the card's output differs from the host "
                "branch's")
        want = (("consensus_segsum", "stable_order")
                if argv[0] == "consensus" else ("flagstat",))
        require(all(card[k] > 0 for k in want) and not any(
            v for k, v in card.items() if k not in want),
            f"{label}: the card run launched {card}")
        n_rows = count_rows(outs["card"])
        require(n_rows > (1000 if argv[0] == "consensus" else 10),
                f"{label}: too few rows")
        n = counts[wl]
        emit({"phase": "consensus", "run": label, "reads": int(n),
              **{f"{e}_wall_s": round(w, 3) for e, w in walls.items()},
              "Mbases_per_s": round(n * READ_LEN / walls["card"] / 1e6, 3),
              "output_bytes": os.path.getsize(outs["card"]),
              "output_rows": n_rows, "launches": card, "byte_equal": True})
        launches[label] = card
        if label == CONSENSUS_RUNS[0][0]:
            # the whole-file run the regions phase holds the index to
            whole_runs[label] = (os.path.join(workdir,
                                              "consensus_region.out"),
                                 walls["card"])
            os.replace(outs.pop("card"), whole_runs[label][0])
        for p in outs.values():
            os.remove(p)

    # --- mpileup --checkpoint: whole, then resumed from its middle state
    fa = os.path.join(workdir, "ref.fa")
    out, ck = os.path.join(workdir, "ck.pileup"), os.path.join(workdir,
                                                               "ck.json")
    states = []
    replace = os.replace

    def keep_state(a, b):
        replace(a, b)
        if b == ck:
            with open(ck) as f:
                states.append(json.load(f))
    walls = {}
    for stage in ("whole", "resumed"):
        if stage == "resumed":
            n_states = len(states)
            mid = states[n_states // 2]
            with open(ck, "w") as f:
                json.dump(mid, f)
            with open(out, "r+") as f:
                f.truncate(mid["out_off"])
                f.seek(mid["out_off"])
                f.write("PARTIAL###")
        kernels.reset_launches()
        os.replace = keep_state
        try:
            walls[stage] = run_cli(["mpileup", "-f", fa, "--checkpoint", ck,
                                    bams["clean"]], out, "-o", False)
        finally:
            os.replace = replace
        runs = dict(kernels.launches)
        require(filecmp.cmp(out, clean_text, shallow=False),
                f"mpileup --checkpoint ({stage}): the output differs from "
                "the tool phase's")
        require(all(runs[k] > 0 for k in MAIN_PATH),
                f"mpileup --checkpoint ({stage}) launched {runs}")
        launches[f"mpileup --checkpoint {stage}"] = runs
    require(n_states == 8 and 0 < mid["out_off"] < os.path.getsize(out)
            and [st["wb"] for st in states[n_states:]]
            == [st["wb"] for st in states[:n_states] if st["wb"] > mid["wb"]],
            f"mpileup --checkpoint: {n_states} states, then "
            f"{len(states) - n_states} after the resume")
    emit({"phase": "consensus", "run": "mpileup --checkpoint",
          "reads": int(counts["clean"]),
          "whole_wall_s": round(walls["whole"], 3),
          "resumed_wall_s": round(walls["resumed"], 3),
          "resumed_at": [mid["tid"], mid["wb"]], "states": n_states,
          "output_bytes": os.path.getsize(out),
          "launches": launches["mpileup --checkpoint whole"],
          "resumed_launches": runs, "byte_equal": True})
    os.remove(out)

    # --- K10 on clean's first 1 Mi window, as the first run built it,
    # then on its hard shapes
    col_off, b6, q, q2, keep, cp, _ = first[0]
    k10 = {"clean": _k10_case(col_off, b6, q, q2, keep, cp, dev)}
    for shape, case in k10_stress_inputs(col_off, b6, q, q2, keep).items():
        k10[shape] = _k10_case(*case, cp, dev)
    rows["consensus_segsum"] = dict(k10["clean"], shapes=k10)

    # --- K11 on clean's reads, and on one flagstat stream batch of them
    rows["flagstat"] = _k11_case(read_alignments(bams["clean"],
                                                 THREADS).batch, dev)
    with BamStream(bams["clean"], threads=2) as st:
        part = next(iter(st.batches(fields=0)))
    rows["flagstat"]["shapes"] = {"clean": dict(rows["flagstat"]),
                                  "stream_batch": _k11_case(part, dev)}
    emit({"phase": "kernels_consensus", **rows})
    return rows, launches, whole_runs


def _k11_case(b, dev) -> dict:
    """K11 on a batch's records: equal to its plain version and to
    ``flagstat_numpy``, one launch a call; times beside the ballot form's
    (scripts/torch_flagstat_narrow_kernels.py) on the same tensors."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import flagstat as fs
    t0 = time.perf_counter()
    want = fs.flagstat_numpy(b)
    np_ms = (time.perf_counter() - t0) * 1e3
    args = [torch.from_numpy(np.ascontiguousarray(a, dt)).to(dev)
            for a, dt in ((b.flag, np.uint16), (b.mapq, np.uint8),
                          (b.tid, np.int32), (b.mtid, np.int32))]
    before = kernels.launches["flagstat"]
    got = fs.flagstat_census(*args)
    require(kernels.launches["flagstat"] == before + 1,
            "K11 did not launch once")
    plain = fs.flagstat_plain(*args)
    require(torch.equal(got, plain), "K11 differs from its plain version")
    require({k: (int(got[i, 0]), int(got[i, 1]))
             for i, k in enumerate(fs.COUNTERS)} == want,
            "K11 differs from flagstat_numpy")
    return dict(
        max_abs_err=0,
        ms=cuda_ms(lambda: fs.flagstat_census(*args)),
        b2b_ms=cuda_ms(lambda: fs.flagstat_census(*args), per=10),
        device_ms=graph_ms(kn().k11_bare(args)),
        plain_ms=cuda_ms(lambda: fs.flagstat_plain(*args)),
        library_ms=cuda_ms(lambda: fs.flagstat_plain(*args)),
        host_flagstat_numpy_ms=np_ms,
        ballot_form=kn().k11_old(old_kernels(), args, got),
        detail={"reads": int(b.n), "blocks": fs.flagstat_plan(
            int(b.n), kernels.sm_count(dev))},
        **dict(zip(("bound_ms", "bound_by"),
                   bound(b.n * 11 + 16 * 2 * 8, b.n * 32))))


def _k10_case(col_off, b6, q, q2, keep, cp, dev) -> dict:
    """K10 on one window's entries: equal to the host's f64 gap5_scores
    bit for bit, the same bits on two calls, within the rounding bound of
    its plain version on the card; times beside its bound, with the
    distinct table rows of each block's columns."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import consensus_vec as cv
    ncols, n = col_off.size - 1, b6.size
    T = cv.segsum_table(cp, dev)
    ent = np.stack([b6, q, q2, keep], 1).astype(np.uint8)
    ent_d = torch.from_numpy(ent).to(dev)
    off_d = torch.from_numpy(np.ascontiguousarray(col_off, np.int64)).to(dev)
    plan = cv.segsum_plan(ncols, kernels.sm_count(dev))
    before = kernels.launches["consensus_segsum"]
    got = cv.consensus_segsum(T, ent_d, off_d)
    again = cv.consensus_segsum(T, ent_d, off_d)
    require(kernels.launches["consensus_segsum"] == before + 2,
            "K10 did not launch")
    require(all(torch.equal(a, b) for a, b in zip(got, again)),
            "K10: two calls give different bits")
    # the host branch's f64 loop: the same S, counts and depth, bit for bit
    t0 = time.perf_counter()
    S64, hc, hd = cv.gap5_scores(col_off, b6, q, q2, keep, cp)
    host_ms = (time.perf_counter() - t0) * 1e3
    kS = got[0].cpu().numpy()
    kc = got[1].cpu().numpy().astype(np.int64)
    kd = got[2].cpu().numpy().astype(np.int64)
    require(np.array_equal(kS.view(np.uint64), S64.view(np.uint64))
            and np.array_equal(kc, hc) and np.array_equal(kd, hd),
            "K10 differs from the f64 gap5_scores")
    require(all(np.array_equal(a, b) for a, b in zip(
        cv.gap5_finalize(kS, kc, kd, cp), cv.gap5_finalize(S64, hc, hd, cp))),
        "K10's five output fields differ from the f64 path's")
    # its plain version on the card adds with atomics, in no fixed order:
    # within the rounding bound of two f64 sums of a column's n terms
    plain = cv.consensus_segsum_plain(T, ent_d, off_d)
    require(torch.equal(got[1], plain[1]) and torch.equal(got[2], plain[2]),
            "K10: counts or depth differ from its plain version")
    e = ent_d.long()
    kept_d = e[:, 3] != 0
    col_k = torch.repeat_interleave(torch.arange(ncols, device=dev),
                                    torch.diff(off_d))[kept_d]
    rows_k = ((e[:, 0] * 101 + e[:, 1]) * 101 + e[:, 2])[kept_d]
    absc = torch.zeros(ncols, 15, dtype=torch.float64, device=dev)
    absc.index_add_(0, col_k, T[rows_k, :15].abs())
    n_c = torch.diff(off_d).double()[:, None]
    dS = (got[0] - plain[0]).abs()
    require(bool((dS <= (n_c + 2) * 2.0 ** -52 * absc).all()),
            "K10: S differs from its plain version beyond the rounding "
            "bound")
    scratch = torch.zeros(ncols, 15, dtype=torch.float64, device=dev)

    def library():
        scratch.zero_()
        scratch.index_add_(0, col_k, T[rows_k, :15])
    # the kernel alone: its bare C entry point on preallocated outputs
    lib = kernels._load()
    outs = [torch.empty_like(t) for t in got]
    ptrs = [t.data_ptr() for t in (T, ent_d, off_d, *outs)]

    def bare():
        return lib.samtpu_consensus_segsum(*ptrs, ncols, *plan,
                                           kernels.stream_of(T))
    require(bare() == 0, "K10's C entry point failed")
    torch.cuda.synchronize()
    require(all(torch.equal(a, b) for a, b in zip(outs, got)),
            "K10's C entry point differs from K10")
    # the distinct table rows of each block's columns (its kept entries),
    # counted on the host: what the L1 of the block's SM must hold
    rid = (b6.astype(np.int64) * 101 + q) * 101 + q2
    span = plan[0] * plan[1]
    cuts = col_off[np.minimum(np.arange(plan[2] + 1) * span, ncols)]
    distinct = np.array([np.unique(rid[lo:hi][keep[lo:hi] != 0]).size
                         for lo, hi in zip(cuts[:-1], cuts[1:])])
    kept = int(keep.sum())
    return dict(
        max_abs_err=float(dS.max()) if ncols else 0.0, max_abs_err_host=0.0,
        ms=cuda_ms(lambda: cv.consensus_segsum(T, ent_d, off_d)),
        b2b_ms=cuda_ms(lambda: cv.consensus_segsum(T, ent_d, off_d),
                       per=10),
        device_ms=graph_ms(bare, calls=10),
        plain_ms=cuda_ms(lambda: cv.consensus_segsum_plain(T, ent_d, off_d),
                         reps=3),
        library_ms=cuda_ms(library, reps=3), host_gap5_scores_ms=host_ms,
        detail={"columns": int(ncols), "entries": int(n), "kept": kept,
                "max_depth": int(np.diff(col_off).max()),
                "plan": dict(zip(("streams", "columns_a_stream", "blocks"),
                                 plan)),
                "distinct_rows_a_block": [int(distinct.min()),
                                          int(np.median(distinct)),
                                          int(distinct.max())],
                "table_bytes_requested": kept * cv.ROW * 8,
                "equal_f64_path_bits": True},
        **dict(zip(("bound_ms", "bound_by"), max(
            (bound(n * 4 + (ncols + 1) * 8 + ncols * (15 * 8 + 6 * 4 + 4),
                   0)[0], "bytes"),
            (kept * 15 / F64_OPS_PER_S * 1e3, "operations")))))


def k10_stress_inputs(col_off, b6, q, q2, keep) -> dict:
    """K10's hard shapes, from clean's window entries (its column offsets
    and per-entry arrays) and seeded draws: name -> (col_off, b6, q, q2,
    keep)."""
    rng = np.random.default_rng(31)
    got = {}
    # amplicon: 2,000 columns 5,000 deep, entries drawn from clean's
    depth = 5000
    pick = rng.integers(0, b6.size, 2000 * depth)
    amp_off = np.arange(2001, dtype=np.int64) * depth
    got["amplicon"] = (amp_off, b6[pick], q[pick], q2[pick], keep[pick])
    # q and q2 uniform on 1-100 over all six bases: a block touches far
    # more distinct rows than an SM's L1 holds
    m = 200_000
    so = col_off[:m + 1]
    k = int(so[-1])
    got["overflow"] = (so, rng.integers(0, 6, k), rng.integers(1, 101, k),
                       rng.integers(1, 101, k), np.ones(k, bool))
    # quals binned to 4 values
    bins = np.array([2, 12, 23, 37])

    def binq(x):
        return bins[np.searchsorted([10, 20, 30], x, side="right")]
    got["binned"] = (so, b6[:k], binq(q[:k]), binq(q2[:k]), keep[:k])
    got["none_kept"] = (so, b6[:k], q[:k], q2[:k], np.zeros(k, bool))
    return got


# stats in-process, card against SAMTPU_DEVICE=0: (label, argv, reads
# counted); {name} a BAM of the earlier phases, {fa} the reference
STATS_RUNS = (
    ("stats", ["stats", "{clean}"], "clean"),
    ("stats", ["stats", "{pairs}"], "pairs"),
    ("stats -r", ["stats", "-r", "{fa}", "{messy_front}"], "messy_front"),
)


def phase_stats(bams: dict, workdir: str, counts: dict) -> dict:
    """stats as a user runs it, card (K12 every chunk) against the host
    branch, byte for byte."""
    import filecmp

    launches = {}
    runs = [(label, [a.format(fa=os.path.join(workdir, "ref.fa"), **bams)
                     for a in argv], "stdout", True)
            for label, argv, _ in STATS_RUNS]
    for (label, _, wl), (_, (wall, card, out), (host, host_out)) in zip(
            STATS_RUNS, card_and_host(runs, workdir, "stats")):
        outs = {"card": out, "host": host_out}
        walls = {"card": wall, "host": host["wall_s"],
                 "host_process": host["process_wall_s"]}
        require(filecmp.cmp(outs["card"], outs["host"], shallow=False),
                f"{label} ({wl}): the card's output differs from the host "
                "branch's")
        n = counts[wl]
        chunks = -(-n // CHUNK)
        require(card["stats_hists"] >= chunks and not any(
            v for k, v in card.items() if k != "stats_hists"),
            f"{label} ({wl}): {chunks} chunks, the card run launched "
            f"{card}")
        n_rows = count_rows(outs["card"])
        require(n_rows > 500, f"{label} ({wl}): too few rows")
        emit({"phase": "stats", "run": label, "input": wl, "reads": int(n),
              **{f"{e}_wall_s": round(w, 3) for e, w in walls.items()},
              "reads_per_s": round(n / walls["card"], 1),
              "Mbases_per_s": round(n * READ_LEN / walls["card"] / 1e6, 3),
              "output_bytes": os.path.getsize(outs["card"]),
              "output_rows": n_rows, "launches": card, "byte_equal": True})
        launches[f"{label} {wl}"] = card
        for p in outs.values():
            os.remove(p)
    return launches


def _k12_case(seq, qual, off, oidx, order, rev, nbases: int, qrows: int,
              dev) -> dict:
    """K12 on one chunk: equal to its plain version on the card and to
    the host library's pass; times beside its bound."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.io import native
    from samtools_tpu_torch.ops import stats_kernels as sk
    args = sk.chunk_inputs(seq, qual, off, oidx, order, rev, dev)
    max_len = int((off[oidx + 1] - off[oidx]).max())
    before = kernels.launches["stats_hists"]
    got = sk.stats_hists(*args, nbases, qrows, max_len)
    torch.cuda.synchronize()
    require(kernels.launches["stats_hists"] == before + 1,
            "K12 did not launch once")
    plain = sk.stats_hists_plain(*args, nbases, qrows)
    require(torch.equal(got, plain), "K12 differs from its plain version")
    host = [np.zeros((qrows, 257), np.int64) for _ in range(2)] + [
        np.zeros((nbases, 6), np.int64) for _ in range(3)]
    t0 = time.perf_counter()
    gc, qsum, mq = native.stats_orig_hists(seq, qual, off, oidx, order, rev,
                                           nbases, *host)
    host_ms = (time.perf_counter() - t0) * 1e3
    h = sk.split_hists(got.cpu().numpy(), oidx.size, nbases, qrows)
    require(all(np.array_equal(h[k], w) for k, w in
                zip(("q1", "q2", "a1", "a2", "ar"), host))
            and np.array_equal(h["gc"], gc)
            and np.array_equal(h["qsum"], qsum) and int(h["maxq"][0]) == mq,
            "K12 differs from the host library's stats_orig_hists")
    # the library alternative: five bincounts of fused keys, built once
    # from the same bases (not timed)
    seq_t, qual_t, off_t, oidx_t, order_t, rev_t = args
    lens = off_t[oidx_t + 1] - off_t[oidx_t]
    seg = torch.repeat_interleave(torch.arange(oidx_t.numel(), device=dev),
                                  lens)
    local = torch.arange(seg.numel(), device=dev) - (torch.cumsum(lens, 0)
                                                     - lens)[seg]
    at = off_t[oidx_t][seg] + local
    rv = rev_t.bool()[seg]
    cyc = torch.where(rv, lens[seg] - 1 - local, local)
    q = qual_t[at].long()
    col = torch.from_numpy(sk.ACGTNO_COL).to(dev)[seq_t[at].long() & 15]
    ordb = order_t[seg]
    keys = []
    for o in (1, 2):
        m = ordb == o
        keys += [(cyc[m] * 257 + q[m], qrows * 257),
                 (cyc[m] * 6 + col[m], nbases * 6)]
    acgt = ((ordb == 1) | (ordb == 2)) & (col < 4)
    keys.append(((cyc * 6 + torch.where(rv, 3 - col, col))[acgt],
                 nbases * 6))
    del seg, local, at, rv, cyc, q, col, ordb

    def library():
        return [torch.bincount(k, minlength=n) for k, n in keys]
    parts = sk.split_hists(plain, oidx.size, nbases, qrows)
    require(all(torch.equal(a, parts[k].reshape(-1)) for a, k in zip(
        library(), ("q1", "a1", "q2", "a2", "ar"))),
        "the bincounts of fused keys differ from K12's plain version")
    nb = int(seq_t.numel())
    nbytes = (2 * nb + off_t.numel() * 8 + oidx.size * (8 + 2)
              + got.numel() * 8)

    def kernel():
        sk.stats_hists(*args, nbases, qrows, max_len)
    # the kernel alone: its bare C entry point (zeroing and launch) on a
    # preallocated output
    lib = kernels._load()
    plan = sk.hists_plan(oidx.size, max_len, kernels.sm_count(dev))
    out = torch.empty_like(got)
    ptrs = [t.data_ptr() for t in args]

    def bare():
        return lib.samtpu_stats_hists(*ptrs, oidx.size, nbases, qrows,
                                      max_len, *plan, out.data_ptr(),
                                      kernels.stream_of(out))
    require(bare() == 0, "K12's C entry point failed")
    torch.cuda.synchronize()
    require(torch.equal(out, got), "K12's C entry point differs from K12")
    return dict(max_abs_err=0, max_abs_err_host=0, ms=cuda_ms(kernel),
                b2b_ms=cuda_ms(kernel, per=10), device_ms=graph_ms(bare),
                plain_ms=cuda_ms(lambda: sk.stats_hists_plain(
                    *args, nbases, qrows), reps=3),
                library_ms=cuda_ms(library), host_stats_orig_hists_ms=host_ms,
                detail={"reads": int(oidx.size), "bases": nb,
                        "nbases": nbases, "qrows": qrows,
                        "max_len": max_len,
                        "plan": dict(zip(("tiles", "rt", "groups",
                                          "per_block"), plan)),
                        "global_atomics": _k12_atomics(
                            seq, qual, off, oidx, order, rev, plan)},
                **dict(zip(("bound_ms", "bound_by"), bound(nbytes, 0))))


def _k12_atomics(seq, qual, off, oidx, order, rev, plan) -> dict:
    """The global atomics K12 makes on these reads under ``plan``,
    counted on the host from its rules: a block adds each of its nonzero
    cells once (the per-block flush), and with several row tiles each
    (read, tile) adds its nonzero GC count and qual sum."""
    from samtools_tpu_torch.ops.stats_kernels import ACGTNO_COL
    tiles, rt, _, per_block = plan
    lens = off[oidx + 1] - off[oidx]
    k = np.repeat(np.arange(oidx.size), lens)
    local = np.arange(k.size) - np.repeat(np.cumsum(lens) - lens, lens)
    at = np.repeat(off[oidx], lens) + local
    b = seq[at].astype(np.int64)
    q = qual[at].astype(np.int64)
    rv = np.repeat(rev, lens).astype(bool)
    cyc = np.where(rv, np.repeat(lens, lens) - 1 - local, local)
    o = np.repeat(order, lens).astype(np.int64)
    tile = cyc // rt
    cell = ((k // per_block) * tiles + tile) * rt + cyc % rt
    col = ACGTNO_COL[b & 15]
    m = (o == 1) | (o == 2)
    acgt = m & (col < 4)
    flush = sum(np.unique(x).size for x in (
        cell[m] * 514 + (o[m] - 1) * 257 + q[m],
        (cell * 6 + col)[o == 1], (cell * 6 + col)[o == 2],
        (cell * 6 + np.where(rv, 3 - col, col))[acgt]))
    per_read = 0
    if tiles > 1:
        rt_key = k * tiles + tile
        gc = (b == 2) | (b == 4)
        per_read = (np.unique(rt_key[gc]).size
                    + np.unique(rt_key[m & (q > 0)]).size)
    return {"flush": int(flush), "per_read": int(per_read),
            "maxq_blocks_at_most": int(plan[0] * plan[2])}


def _census_narrow_case(census, wlen: int) -> dict:
    """K7n on rows [0, wlen) of a resident census: equal to its plain
    version (types and bytes) in one launch; times beside its bound and
    the two-pass form's (scripts/torch_flagstat_narrow_kernels.py), the share
    of the rows staged in shared memory."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import mpileup_device as md
    before = kernels.launches["census_narrow"]
    got = md.census_narrow(census, wlen)
    torch.cuda.synchronize()
    require(kernels.launches["census_narrow"] == before + 1,
            "K7n did not launch once")
    want = md.census_narrow_plain(census, wlen)
    require(got[1:] == want[1:] and torch.equal(got[0], want[0]),
            "K7n differs from its plain version")
    cdt, qdt = got[1], got[2]
    c = census[:wlen]
    blocks, rows, staged = md.narrow_plan(
        wlen, *md._narrow_limits(census.device))

    def library():
        return (c[:, :5].amax(), c[:, 5].amax(), c[:, :5].to(cdt),
                c[:, 5].to(qdt))
    return dict(max_abs_err=0, ms=cuda_ms(lambda: md.census_narrow(
        census, wlen)), b2b_ms=cuda_ms(lambda: md.census_narrow(
            census, wlen), per=10),
        device_ms=graph_ms(kn().k7n_bare(census, wlen)),
        plain_ms=cuda_ms(lambda: md.census_narrow_plain(census, wlen)),
        library_ms=cuda_ms(library),
        two_pass_form=kn().k7n_old(old_kernels(), census, wlen, got),
        detail={"rows": wlen, "counts": str(cdt), "qual_sums": str(qdt),
                "fetched_bytes": int(got[0].numel()),
                "int32_bytes": wlen * 24,
                "plan": {"blocks": blocks, "rows": rows, "staged": staged},
                "staged_share": min(wlen, blocks * staged) / wlen},
        **dict(zip(("bound_ms", "bound_by"),
                   bound(wlen * 24 + got[0].numel() + 8, 0))))


def k12_stress_inputs(seq, qual, off, order, rev) -> dict:
    """K12's hard shapes, from a chunk of clean (its flat columns, the
    orders and strands of its first CHUNK reads) and seeded synthetic
    reads: name -> (seq, qual, off, oidx, order, rev, nbases, qrows)."""
    rng = np.random.default_rng(29)
    n = order.size
    oidx = np.arange(n, dtype=np.int64)
    codes = np.array([1, 2, 4, 8, 15, 5], np.uint8)
    p = [.24, .24, .24, .24, .02, .02]
    got = {}
    # quals binned to 4 values, as Illumina reports them: shared-atomic
    # collisions across warps
    binned = np.array([2, 12, 23, 37], np.uint8)[
        np.searchsorted([10, 20, 30], qual, side="right")]
    got["binned"] = (seq, binned, off, oidx, order, rev, 300, 300)
    # runs of 4,096 selected reads with gaps of 8,192 between them
    keep = (oidx // 4096) % 3 == 0
    got["gaps"] = (seq, qual, off, oidx[keep], order[keep], rev[keep], 300,
                   301)
    got["single"] = (seq, qual, off, oidx[:1], order[:1], rev[:1], 300, 300)
    # a quarter of the reads with no bases
    lens = rng.integers(1, 151, n)
    lens[rng.random(n) < .25] = 0
    so = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    got["empty"] = (rng.choice(codes, int(so[-1]), p=p),
                    rng.integers(2, 41, int(so[-1])).astype(np.uint8), so,
                    oidx, order, rev, 150, 151)
    # 200 reads of 20,000 bases: a hundred row tiles
    m = 200
    so = np.arange(m + 1, dtype=np.int64) * 20000
    got["long_20k"] = (rng.choice(codes, int(so[-1]), p=p),
                       rng.integers(0, 94, int(so[-1])).astype(np.uint8), so,
                       np.arange(m, dtype=np.int64),
                       rng.integers(0, 3, m).astype(np.uint8),
                       rng.integers(0, 2, m).astype(np.uint8), 20000, 20001)
    return got


def phase_kernels_stats(bams: dict, ref: np.ndarray, ref_int: np.ndarray,
                        dev, core_census) -> dict:
    """K12 on chunks of clean, the pairs and long synthetic reads; K7n on
    clean's core census and on a 300x census; K7's checksum on clean's
    core census and on the tool's window of it."""
    from samtools_tpu_torch.io.stream import BamStream
    from samtools_tpu_torch.ops import mpileup_device as md
    from samtools_tpu_torch.sim import simulate_batch
    rows, k12 = {}, {}
    for name in ("clean", "pairs"):
        with BamStream(bams[name], threads=THREADS) as st:
            b = next(iter(st.batches()))
        oidx = np.arange(min(b.n, CHUNK), dtype=np.int64)
        flag = b.flag[oidx].astype(np.int64)
        order = np.where(flag & 1, ((flag & 64) != 0)
                         + 2 * ((flag & 128) != 0), 1).astype(np.uint8)
        rev = ((flag & 16) != 0).astype(np.uint8)
        # a run's first chunk: nbases 300, as many quality rows
        k12[name] = _k12_case(b.seq, b.qual, b.seq_off, oidx, order, rev,
                              300, 300, dev)
        if name == "clean":
            for shape, case in k12_stress_inputs(
                    b.seq, b.qual, b.seq_off, order, rev).items():
                k12[shape] = _k12_case(*case, dev)
        del b
    # reads of 30-1,000 bases after the histograms grew to 1,000 cycles
    rng = np.random.default_rng(21)
    n = 16384
    lens = rng.integers(30, 1001, n)
    off = np.concatenate([[0], np.cumsum(lens)]).astype(np.int64)
    seq = rng.choice(np.array([1, 2, 4, 8, 15, 5], np.uint8), int(off[-1]),
                     p=[.24, .24, .24, .24, .02, .02])
    qual = rng.integers(0, 256, int(off[-1])).astype(np.uint8)
    k12["long"] = _k12_case(seq, qual, off, np.arange(n, dtype=np.int64),
                            rng.integers(0, 3, n).astype(np.uint8),
                            rng.integers(0, 2, n).astype(np.uint8), 1000,
                            1001, dev)
    rows["stats_hists"] = dict(k12["clean"], chunks=k12)
    emit({"phase": "kernels_stats", "stats_hists": k12})

    # an amplicon-deep census: 300x reads over 4 kbp, counts past 255 (a
    # pile of displaced reads does not do: BAQ drops their mismatching
    # bases below the quality gate)
    L = 4096
    deep = md.DeviceCensusPipeline(ref_int[:L], L, device=dev)
    deep.add_batch(simulate_batch(ref_len=L, coverage=300.0,
                                  read_len=READ_LEN, seed=23, paired=False,
                                  err_rate=0.01, ref=ref[:L]))
    deep._flush()
    narrow = {"core_clean": _census_narrow_case(core_census, REF_LEN),
              "tool_window_clean": _census_narrow_case(core_census,
                                                       WINDOW_ROWS),
              "deep_300x": _census_narrow_case(deep.census_dev, L)}
    require(narrow["deep_300x"]["detail"]["counts"] == "torch.uint16",
            "the 300x census did not narrow to u16")
    del deep
    rows["census_narrow"] = dict(narrow["core_clean"], censuses=narrow)
    # K7's checksum on the same census, on its 8 Mi rows and on the
    # tool's window of 1 Mi
    rows["census_checksum"] = checksum = _k7_case(core_census, REF_LEN)
    checksum["windows"] = {"tool_window_clean": _k7_case(core_census,
                                                         WINDOW_ROWS)}
    emit({"phase": "kernels_stats", "census_narrow": narrow,
          "census_checksum": checksum})
    return rows


def _k7_case(census, wlen: int) -> dict:
    """K7 on rows [0, wlen) of ``census``: equal to its plain version on
    the card and to the host's ``census_checksum``, the wrapper's time
    (its launch, and the fetch of the two words: a host sync a call, so
    back-to-back calls do not overlap), the kernel alone (a CUDA graph of
    the bare C entry, the output's zeroing included), the plain version,
    ``torch.sum`` of the weighted lanes (built once, not timed) and the
    bound from bytes."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import mpileup_device as md
    c = census[:wlen]
    h = c.cpu().numpy()
    want = md.census_checksum(h[:, :5], h[:, 5])
    before = kernels.launches["census_checksum"]
    got = md.census_checksum_dev(census, wlen)
    require(kernels.launches["census_checksum"] == before + 1,
            "K7 did not launch once")
    plain = md.census_checksum_plain(census, wlen)
    require(got == want == plain, f"K7's checksum {got} differs from its "
            f"plain version {plain} or census_checksum {want}")
    lib = kernels._load()
    out = torch.zeros(2, dtype=torch.int32, device=census.device)
    blocks = md.checksum_plan(wlen, kernels.sm_count(census.device))

    # on the current stream at each call: the graph's capture stream
    # while graph_ms captures
    def bare():
        out.zero_()
        require(lib.samtpu_census_checksum(
            census.data_ptr(), wlen, blocks, out.data_ptr(),
            kernels.stream_of(census)) == 0, "K7's C entry point failed")
    bare()
    require([v & 0xFFFFFFFF for v in out.tolist()] == list(got),
            "K7's C entry point differs from its wrapper")
    v = torch.cat([c[:, :5].reshape(-1), c[:, 5]]).to(torch.int64)
    idx = torch.arange(v.numel(), dtype=torch.int64, device=census.device)
    weighted = md._mulmod32(v, md._mulmod32(idx, torch.full_like(
        idx, 2654435761)))
    del v, idx
    row = dict(
        max_abs_err=0,
        ms=cuda_ms(lambda: md.census_checksum_dev(census, wlen)),
        b2b_ms=cuda_ms(lambda: md.census_checksum_dev(census, wlen),
                       per=10),
        device_ms=graph_ms(bare),
        plain_ms=cuda_ms(lambda: md.census_checksum_plain(census, wlen),
                         reps=3),
        library_ms=cuda_ms(lambda: torch.sum(weighted)),
        detail={"rows": wlen, "blocks": blocks},
        **dict(zip(("bound_ms", "bound_by"), bound(wlen * 24 + 8, 0))))
    del weighted
    return row


# the regions phase's card runs: (label, argv; {bam}: the input)
REGION = "sim1:3000001-4000000"
REGION_RUNS = (
    ("mpileup -r", ["mpileup", "-f", "{fa}", "-r", REGION, "{bam}"],
     "stdout"),
    ("depth -a -r", ["depth", "-a", "-r", REGION, "{bam}"], "stdout"),
)
SAM_END = 500_000
SAM_RUNS = (
    ("mpileup", ["mpileup", "-f", "{fa}", "{bam}"]),
    ("flagstat", ["flagstat", "{bam}"]),
    ("stats", ["stats", "{bam}"]),
)
QUERY_FIELDS = ("pos", "flag", "cigar", "cigar_off", "seq", "seq_off", "qual")
# the cram phase: clean's reads that start before this, as CRAM and BAM;
# its card runs (label, argv, the kernels each must launch)
CRAM_END = 100_000
CRAM_RUNS = (
    ("mpileup", ["mpileup", "-f", "{fa}", "{bam}"], MAIN_PATH),
    ("depth -a", ["depth", "-a", "{bam}"], ("segment_contract",
                                            "depth_scan")),
    ("flagstat", ["flagstat", "{bam}"], ("flagstat",)),
    ("stats", ["stats", "{bam}"], ("stats_hists",)),
)
CRAM_FIELDS = ("tid", "pos", "mapq", "flag", "mtid", "mpos", "tlen",
               "qname", "qname_off", "cigar", "cigar_off", "seq", "seq_off",
               "qual", "aux", "aux_off")


def write_sam(path: str, header, b) -> None:
    """``b`` as SAM text (reads without aux fields, mates or '=' bases)."""
    require(b.aux.size == 0 and bool((b.mtid < 0).all()),
            "write_sam takes reads without aux fields or mates")
    seq = np.frombuffer(b"=ACMGRSVTWYHKDBN", np.uint8)[b.seq].tobytes()
    qual = (b.qual + 33).astype(np.uint8).tobytes()
    qname = b.qname.tobytes()
    so, co, qo = (b.seq_off.tolist(), b.cigar_off.tolist(),
                  b.qname_off.tolist())
    cig = b.cigar.tolist()
    names = header.ref_names
    lines = [header.text]
    for i, (flag, tid, pos, mapq) in enumerate(zip(
            b.flag.tolist(), b.tid.tolist(), b.pos.tolist(),
            b.mapq.tolist())):
        c = "".join(f"{x >> 4}{'MIDNSHP=XB'[x & 15]}"
                    for x in cig[co[i]:co[i + 1]]) or "*"
        lines.append(
            f"{qname[qo[i]:qo[i + 1]].decode()}\t{flag}\t"
            f"{names[tid] if tid >= 0 else '*'}\t{pos + 1}\t{mapq}\t{c}"
            f"\t*\t0\t0\t{seq[so[i]:so[i + 1]].decode()}\t"
            f"{qual[so[i]:so[i + 1]].decode()}\n")
    with open(path, "w") as f:
        f.write("".join(lines))


def stdout_lines(path: str) -> list[bytes]:
    """A run's output lines less stats' command-line line, which names
    the input."""
    with open(path, "rb") as f:
        return [ln for ln in f.read().split(b"\n")
                if not ln.startswith(b"# The command line")]


def phase_regions(workdir: str, bams: dict, cons: dict,
                  cons_whole: dict) -> tuple:
    """``index`` (BAI, then CSI on a copy), ``BamStream.query`` and
    ``idxstats`` on clean against whole-file reads; ``-r`` through the
    index in mpileup, depth and consensus against the unindexed file;
    SAM text against BAM.  Returns clean's header and its reads that
    start before ``CRAM_END`` (the cram phase's input)."""
    import filecmp
    import shutil

    from samtools_tpu_torch import cli, kernels
    from samtools_tpu_torch.io import bgzf
    from samtools_tpu_torch.io.bam import read_bam_indexed, write_bam
    from samtools_tpu_torch.io.stream import BamStream
    clean = bams["clean"]
    fa = os.path.join(workdir, "ref.fa")
    noidx = os.path.join(workdir, "clean_noidx.bam")
    csi = os.path.join(workdir, "clean_csi.bam")
    shutil.copy(clean, noidx)
    shutil.copy(clean, csi)
    walls = {}
    for label, argv in (("index", ["index", clean]),
                        ("index -c", ["index", "-c", csi])):
        t0 = time.perf_counter()
        require(cli.main(argv) == 0, f"{label} failed")
        walls[label] = time.perf_counter() - t0
    require(os.path.exists(clean + ".bai") and os.path.exists(csi + ".csi"),
            "index wrote no BAI or CSI")
    t0 = time.perf_counter()
    header, whole, vstart, vend = read_bam_indexed(clean, THREADS)
    walls["whole-file read"] = time.perf_counter() - t0
    with open(clean, "rb") as f:
        nblocks = int(bgzf.scan_blocks(f.read())[0].size)
    # five seeded regions: 1 kbp, 1 kbp around a read whose bytes cross a
    # BGZF block boundary, 100 kbp, 2 Mbp, the contig's last 50 kbp
    rng = np.random.default_rng(9)
    cross = np.nonzero(((vstart >> np.uint64(16)) != (vend >> np.uint64(16)))
                       & ((vend & np.uint64(0xFFFF)) != 0))[0]
    require(cross.size > 0, "no read crosses a block boundary")
    at = int(whole.pos[cross[cross.size // 2]])
    regions = []
    for beg, span in ((int(rng.integers(0, REF_LEN - 1000)), 1000),
                      (at - 500, 1000),
                      (int(rng.integers(0, REF_LEN - 100_000)), 100_000),
                      (int(rng.integers(0, REF_LEN - 2_000_000)), 2_000_000),
                      (REF_LEN - 50_000, 50_000)):
        regions.append((beg, beg + span))
    end_pos = whole.end_pos()
    queries = []
    for path, fmt in ((clean, "bai"), (csi, "csi")):
        with BamStream(path, threads=THREADS) as st:
            require(st.index() is not None, f"no {fmt} index found")
            for beg, end in regions:
                t0 = time.perf_counter()
                got = st.query(0, beg, end)
                t_q = time.perf_counter() - t0
                want = whole.take(np.nonzero((whole.pos < end)
                                             & (end_pos > beg))[0])
                require(got.n == want.n > 0 and all(
                    np.array_equal(getattr(got, k), getattr(want, k))
                    for k in QUERY_FIELDS),
                    f"{fmt} query [{beg}, {end}) differs from the "
                    "whole-file filter")
                queries.append({"index": fmt, "beg": beg, "end": end,
                                "reads": int(got.n),
                                "query_s": round(t_q, 4)})
    emit({"phase": "regions", "run": "index, query", "reads": int(whole.n),
          "bgzf_blocks": nblocks,
          **{f"{k}_wall_s": round(v, 3) for k, v in walls.items()},
          "queries": queries, "equal_whole_file_filter": True})
    front = whole.take(np.nonzero(whole.pos < SAM_END)[0])
    del whole, vstart, vend, end_pos

    # idxstats: the BAI's and the CSI's counts against a whole-file count
    outs = {}
    for label, path in (("bai", clean), ("csi", csi), ("none", noidx)):
        outs[label] = os.path.join(workdir, f"idxstats.{label}.txt")
        walls[f"idxstats {label}"] = run_cli(["idxstats", path],
                                             outs[label], "stdout", False)
    require(filecmp.cmp(outs["bai"], outs["none"], shallow=False)
            and filecmp.cmp(outs["csi"], outs["none"], shallow=False),
            "idxstats through the index differs from the whole-file count")
    with open(outs["none"]) as f:
        idxstats_text = f.read()
    emit({"phase": "regions", "run": "idxstats", "output": idxstats_text,
          **{f"{k}_wall_s": round(walls[f"idxstats {k}"], 3)
             for k in outs}, "byte_equal": True})
    for p in outs.values():
        os.remove(p)

    # -r through the index on the card, against the unindexed copy
    runs = [(label, [a.format(fa=fa, bam=noidx) for a in argv], to)
            for label, argv, to in REGION_RUNS]
    for label, argv, to in runs:
        outs, launched, w = {}, {}, {}
        for which, bam in (("indexed", clean), ("whole", noidx)):
            outs[which] = os.path.join(workdir, f"region.{which}.out")
            kernels.reset_launches()
            w[which] = run_cli([bam if a == noidx else a for a in argv],
                               outs[which], to, False)
            launched[which] = dict(kernels.launches)
        require(filecmp.cmp(outs["indexed"], outs["whole"], shallow=False),
                f"{label}: the indexed run differs from the whole-file run")
        used = {k for k, v in launched["indexed"].items() if v}
        require(used and used == {k for k, v in launched["whole"].items()
                                  if v},
                f"{label}: launches {launched}")
        emit({"phase": "regions", "run": label, "region": REGION,
              "indexed_wall_s": round(w["indexed"], 3),
              "whole_file_wall_s": round(w["whole"], 3),
              "output_bytes": os.path.getsize(outs["indexed"]),
              "output_rows": count_rows(outs["indexed"]),
              "launches": launched["indexed"],
              "whole_file_launches": launched["whole"], "byte_equal": True})
        for p in outs.values():
            os.remove(p)
    label = CONSENSUS_RUNS[0][0]
    whole_out, whole_wall = cons_whole[label]
    out = os.path.join(workdir, "region.indexed.out")
    kernels.reset_launches()
    wall = run_cli([a.format(clean=clean) for a in CONSENSUS_RUNS[0][1]],
                   out, "-o", False)
    launched = dict(kernels.launches)
    require(filecmp.cmp(out, whole_out, shallow=False),
            f"{label}: the indexed run differs from the whole-file run")
    require({k for k, v in launched.items() if v}
            == {k for k, v in cons[label].items() if v},
            f"{label}: launches {launched} against {cons[label]}")
    emit({"phase": "regions", "run": label, "region": "sim1:1-1000000",
          "indexed_wall_s": round(wall, 3),
          "whole_file_wall_s": round(whole_wall, 3),
          "output_bytes": os.path.getsize(out), "launches": launched,
          "whole_file_launches": cons[label], "byte_equal": True})
    os.remove(out)
    os.remove(whole_out)

    # SAM text of clean's reads that start in its first 1 Mbp, against
    # the BAM of the same reads
    sam = os.path.join(workdir, "clean_1m.sam")
    bam = os.path.join(workdir, "clean_1m.bam")
    t0 = time.perf_counter()
    write_sam(sam, header, front)
    t_sam = time.perf_counter() - t0
    write_bam(bam, header, front, threads=THREADS)
    n_front = int(front.n)
    cram_reads = front.take(np.nonzero(front.pos < CRAM_END)[0])
    del front
    for label, argv in SAM_RUNS:
        outs, launched, w = {}, {}, {}
        for which, path in (("sam", sam), ("bam", bam)):
            outs[which] = os.path.join(workdir, f"sam.{which}.out")
            kernels.reset_launches()
            w[which] = run_cli([a.format(fa=fa, bam=path) for a in argv],
                               outs[which], "stdout", False)
            launched[which] = dict(kernels.launches)
        require(stdout_lines(outs["sam"]) == stdout_lines(outs["bam"]),
                f"{label}: SAM input prints other bytes than BAM input")
        used = {k for k, v in launched["sam"].items() if v}
        require(used and used == {k for k, v in launched["bam"].items()
                                  if v},
                f"{label}: launches {launched}")
        emit({"phase": "regions", "run": f"{label} SAM", "reads": n_front,
              "write_sam_s": round(t_sam, 3),
              "sam_wall_s": round(w["sam"], 3),
              "bam_wall_s": round(w["bam"], 3),
              "output_bytes": os.path.getsize(outs["sam"]),
              "launches": launched["sam"], "bam_launches": launched["bam"],
              "byte_equal": True})
        for p in outs.values():
            os.remove(p)
    for p in (sam, bam, noidx, csi, csi + ".csi", clean + ".bai"):
        os.remove(p)
    return header, cram_reads


def phase_cram(workdir: str, ref: np.ndarray, header, reads) -> dict:
    """``reads`` as CRAM 3.0 (the port's encoder, the reference found
    through ``REF_CACHE`` by the ``@SQ`` M5) and as BAM: the decoded CRAM
    equals the reads; mpileup, depth, flagstat and stats print the same
    bytes on both and launch the same kernels; idxstats and index on the
    CRAM.  Returns each run's launches on the CRAM, and the paths of the
    BAM twin (kept for the view_tools phase) and of the CRAM (kept for
    the header_tools phase; its reference stays in ``ref_cache``)."""
    import filecmp
    import hashlib

    from samtools_tpu_torch import cli, kernels
    from samtools_tpu_torch.io.bam import write_bam
    from samtools_tpu_torch.io.files import read_alignments, write_alignments
    from samtools_tpu_torch.io.header import SamHeader
    fa = os.path.join(workdir, "ref.fa")
    md5 = hashlib.md5(ref.tobytes().upper()).hexdigest()
    cache = os.path.join(workdir, "ref_cache")
    os.makedirs(cache, exist_ok=True)
    with open(os.path.join(cache, md5), "wb") as f:
        f.write(ref.tobytes().upper())
    lines = header.text.split("\n")
    require(sum(ln.startswith("@SQ") for ln in lines) == 1,
            "clean's header has one @SQ line")
    text = "\n".join(ln + f"\tM5:{md5}" if ln.startswith("@SQ") else ln
                     for ln in lines)
    hdr = SamHeader.from_text(text)
    cram = os.path.join(workdir, "clean_cram.cram")
    bam = os.path.join(workdir, "clean_cram.bam")
    saved = os.environ.get("REF_CACHE")
    os.environ["REF_CACHE"] = cache
    try:
        n = int(reads.n)
        t0 = time.perf_counter()
        write_alignments(cram, hdr, reads, fmt="cram")
        t_enc = time.perf_counter() - t0
        write_bam(bam, hdr, reads, threads=THREADS)
        t0 = time.perf_counter()
        got = read_alignments(cram)
        t_dec = time.perf_counter() - t0
        require(got.format == "cram" and got.header.text == hdr.text
                and got.batch.n == n and all(
                    np.array_equal(getattr(got.batch, k), getattr(reads, k))
                    for k in CRAM_FIELDS),
                "the decoded CRAM differs from the reads written")
        del got
        emit({"phase": "cram", "run": "encode, decode", "reads": n,
              "cram_bytes": os.path.getsize(cram),
              "bam_bytes": os.path.getsize(bam),
              "encode_s": round(t_enc, 3), "decode_s": round(t_dec, 3),
              "encode_s_per_read": t_enc / n, "decode_s_per_read": t_dec / n,
              "equal_reads": True})
        runs = {}
        for label, argv, want in CRAM_RUNS:
            outs, launched, w = {}, {}, {}
            for which, path in (("cram", cram), ("bam", bam)):
                outs[which] = os.path.join(workdir, f"cram.{which}.out")
                kernels.reset_launches()
                w[which] = run_cli([a.format(fa=fa, bam=path) for a in argv],
                                   outs[which], "stdout", False)
                launched[which] = dict(kernels.launches)
            require(stdout_lines(outs["cram"]) == stdout_lines(outs["bam"]),
                    f"{label}: CRAM input prints other bytes than BAM input")
            used = {k for k, v in launched["cram"].items() if v}
            require(used >= set(want) and used == {
                k for k, v in launched["bam"].items() if v},
                f"{label}: launches {launched}")
            runs[label] = launched["cram"]
            emit({"phase": "cram", "run": label, "reads": n,
                  "cram_wall_s": round(w["cram"], 3),
                  "bam_wall_s": round(w["bam"], 3),
                  "output_bytes": os.path.getsize(outs["cram"]),
                  "launches": launched["cram"],
                  "bam_launches": launched["bam"], "byte_equal": True})
            for p in outs.values():
                os.remove(p)
        outs, w = {}, {}
        for which, path in (("cram", cram), ("bam", bam)):
            outs[which] = os.path.join(workdir, f"idxstats.{which}.txt")
            w[which] = run_cli(["idxstats", path], outs[which], "stdout",
                               False)
        require(filecmp.cmp(outs["cram"], outs["bam"], shallow=False),
                "idxstats on the CRAM differs from idxstats on the BAM")
        t0 = time.perf_counter()
        require(cli.main(["index", cram]) == 0, "index on the CRAM failed")
        t_idx = time.perf_counter() - t0
        crai = os.path.getsize(cram + ".crai") \
            if os.path.exists(cram + ".crai") else 0
        require(crai > 0, "index wrote no .crai")
        emit({"phase": "cram", "run": "idxstats, index",
              "idxstats_cram_wall_s": round(w["cram"], 3),
              "idxstats_bam_wall_s": round(w["bam"], 3),
              "index_wall_s": round(t_idx, 3), "crai_bytes": crai,
              "byte_equal": True})
        for p in (*outs.values(), cram + ".crai"):
            os.remove(p)
    finally:
        os.environ.pop("REF_CACHE", None)
        if saved is not None:
            os.environ["REF_CACHE"] = saved
    return runs, bam, cram


# the pileup_tools phase: targetcut's documented use is a fosmid pool, so
# a 200 kbp contig with reads at 30x over three 40 kbp islands (the
# fosmids) of a diploid sample, a het SNP about every kbp
TOOLS_LEN = 200_000
TOOLS_ISLANDS = ((10_000, 50_000), (80_000, 120_000), (150_000, 190_000))
TOOLS_SEED = 23
# (label, argv, the kernels each card run launches); {fa}, {bam}: the
# inputs, {pre}: phase -b's prefix.  tview's windows: an island's start, an
# island's middle, a gap between islands (no reads: no launch)
_TVIEW = ["tview", "-w", "120", "-p"]
TOOLS_RUNS = (
    ("phase -b", ["phase", "-b", "{pre}", "{bam}"], ("stable_order",)),
    ("targetcut -f", ["targetcut", "-f", "{fa}", "{bam}"],
     ("baq_apply", "apply_expand", "baq_hmm", "baq_finalize",
      "stable_order")),
    ("phase", ["phase", "{bam}"], ("stable_order",)),
    ("tview -d T island start", [*_TVIEW, "sim1:10001", "-d", "T", "{bam}",
                                 "{fa}"], ("stable_order",)),
    ("tview -d T island middle", [*_TVIEW, "sim1:100001", "-d", "T",
                                  "{bam}", "{fa}"], ("stable_order",)),
    ("tview -d T gap", [*_TVIEW, "sim1:65001", "-d", "T", "{bam}", "{fa}"],
     ()),
    ("tview -d H", [*_TVIEW, "sim1:170001", "-d", "H", "{bam}", "{fa}"],
     ("stable_order",)),
)


def diploid_islands():
    """The pileup_tools cell: a reference of TOOLS_LEN bases (seeded), a
    second haplotype that differs from it at a het SNP every 500-1,500
    bases, and 100 bp single-end reads at 15x from each haplotype over
    each of TOOLS_ISLANDS (30x in all), with distinct qnames
    (``h<hap>i<island>_`` before the simulator's), merged by position.
    Returns (reference, reads, het SNPs)."""
    from samtools_tpu_torch.core.batch import ReadBatch
    from samtools_tpu_torch.sim import simulate_batch, simulate_reference
    ref = simulate_reference(TOOLS_LEN, seed=TOOLS_SEED)
    rng = np.random.default_rng(TOOLS_SEED)
    het = np.cumsum(rng.integers(500, 1500, TOOLS_LEN // 500))
    het = het[het < TOOLS_LEN]
    hap2 = ref.copy()
    hap2[het] = np.frombuffer(b"ACGT", np.uint8)[
        (ref_codes(ref[het]).astype(np.int64)
         + rng.integers(1, 4, het.size)) % 4]
    parts = []
    for k, (beg, end) in enumerate(TOOLS_ISLANDS):
        for h, hap in enumerate((ref, hap2)):
            b = simulate_batch(ref_len=end - beg, coverage=COVERAGE / 2,
                               read_len=READ_LEN, paired=False,
                               seed=TOOLS_SEED * 100 + 2 * k + h,
                               ref=np.ascontiguousarray(hap[beg:end]))
            b.pos = b.pos + beg
            names = [b"h%di%d_" % (h, k)
                     + bytes(b.qname[b.qname_off[i]:b.qname_off[i + 1]])
                     for i in range(b.n)]
            b.qname = np.frombuffer(b"".join(names), np.uint8).copy()
            b.qname_off = np.concatenate(
                [[0], np.cumsum([len(x) for x in names])]).astype(np.int64)
            parts.append(b)
    b = ReadBatch.concat(parts)
    return ref, b.take(np.argsort(b.pos, kind="stable")), int(het.size)


def write_tools_inputs(workdir: str) -> dict:
    """The pileup_tools cell as a BAM and its FASTA under ``workdir``."""
    from samtools_tpu_torch.io.bam import write_bam
    from samtools_tpu_torch.sim import make_header
    ref, b, n_het = diploid_islands()
    got = {"bam": os.path.join(workdir, "islands.bam"),
           "fa": os.path.join(workdir, "islands.fa"),
           "reads": int(b.n), "het_snps": n_het}
    write_bam(got["bam"], make_header(TOOLS_LEN), b, threads=THREADS)
    write_fasta(got["fa"], ref)
    return got


def _decoded_bams(prefix: str) -> dict:
    """phase -b's three BAMs decoded (header text, @SQ list, every
    column), removed after reading."""
    import glob

    from samtools_tpu_torch.io.files import read_alignments
    got = {}
    for path in sorted(glob.glob(prefix + ".*")):
        f = read_alignments(path)
        got[os.path.basename(path)] = (
            f.header.text, f.header.ref_names, f.header.ref_lens, f.batch.n,
            {k: getattr(f.batch, k).tobytes() for k in vars(f.batch)
             if k != "n"})
        os.remove(path)
    return got


def _host_process(argv: list[str], out: str) -> float:
    """The port's command as a fresh process on its host branch
    (``SAMTPU_DEVICE=0``), standard output to ``out``; its wall, the
    interpreter's start included."""
    env = dict(os.environ, SAMTPU_DEVICE="0")
    t0 = time.perf_counter()
    with open(out, "wb") as f:
        p = subprocess.run([sys.executable, "-m", "samtools_tpu_torch",
                            *argv], stdout=f, stderr=subprocess.PIPE,
                           env=env, cwd=ROOT, timeout=900)
    require(p.returncode == 0, f"{' '.join(argv[:2])} (host branch): rc "
            f"{p.returncode}: {p.stderr.decode()[-500:]}")
    return time.perf_counter() - t0


def phase_pileup_tools(workdir: str) -> dict:
    """targetcut -f, phase, phase -b and tview (three text windows, one
    HTML) in-process on the card, each against the same command as a
    process on the host branch (four at a time beside the card's runs):
    the same bytes (for -b, the same decoded BAMs), and the card runs
    launch K8 with its front, K4 and K5 (targetcut -f, a front launch a
    K8 chunk) and K13 (at least once a contig; once a tview draw on a
    window with reads, none on the gap).
    Returns each card run's launches."""
    from samtools_tpu_torch import kernels
    t_phase = time.perf_counter()
    cell = write_tools_inputs(workdir)
    emit({"phase": "pileup_tools", "run": "inputs", "contig_len": TOOLS_LEN,
          "islands": TOOLS_ISLANDS, "reads": cell["reads"],
          "het_snps": cell["het_snps"], "coverage": COVERAGE})
    pre = os.path.join(workdir, "phased")
    argvs = {label: [a.format(pre=pre, **cell) for a in argv]
             for label, argv, _ in TOOLS_RUNS}
    host_out = {label: os.path.join(workdir, f"tools{i}.host")
                for i, (label, _, _) in enumerate(TOOLS_RUNS)}
    runs, card, bams = {}, {}, None
    ex = ThreadPoolExecutor(4)
    try:
        # the host runs, the longest first; phase -b's once the card's has
        # written its BAMs and they are read (the same prefix, so the @PG
        # command lines match)
        host = {label: ex.submit(_host_process, argvs[label],
                                 host_out[label])
                for label, _, _ in TOOLS_RUNS if label != "phase -b"}
        for i, (label, _, want) in enumerate(TOOLS_RUNS):
            out = os.path.join(workdir, f"tools{i}.card")
            kernels.reset_launches()
            wall = run_cli(argvs[label], out, "stdout", False)
            launched = dict(kernels.launches)
            used = {k for k, v in launched.items() if v}
            require(used == set(want)
                    and launched["apply_expand"] == launched["baq_apply"],
                    f"{label}: launches {launched}")
            if label.startswith("tview"):
                # one draw: one K13 launch on a window with reads
                require(launched["stable_order"] == (1 if want else 0),
                        f"{label}: K13 {launched['stable_order']} a draw")
            if label == "phase -b":
                bams = _decoded_bams(pre)
                # a het every kbp makes one-marker phase sets: no read
                # is flipped, so the chimera file may be empty
                require(len(bams) == 3 and all(
                    bams[f"phased.{c}.bam"][3] for c in (0, 1)),
                    f"phase -b wrote {sorted(bams)}")
                host[label] = ex.submit(_host_process, argvs[label],
                                        host_out[label])
            card[label] = (wall, out)
            runs[label] = launched
        for label, _, _ in TOOLS_RUNS:
            host_wall = host[label].result()
            wall, out = card[label]
            with open(out, "rb") as f:
                card_bytes = f.read()
            with open(host_out[label], "rb") as f:
                require(f.read() == card_bytes,
                        f"{label}: the card prints other bytes than the "
                        "host branch")
            if label == "phase -b":
                require(_decoded_bams(pre) == bams,
                        "phase -b: the host branch's BAMs differ")
            os.remove(out)
            os.remove(host_out[label])
            emit({"phase": "pileup_tools", "run": label,
                  "reads": cell["reads"], "card_wall_s": round(wall, 3),
                  "host_process_wall_s": round(host_wall, 3),
                  "output_bytes": len(card_bytes),
                  "output_lines": card_bytes.count(b"\n"),
                  "launches": runs[label], "byte_equal": True,
                  **({"bam_records": {k: v[3] for k, v in bams.items()}}
                     if label == "phase -b" else {})})
    finally:
        ex.shutdown(wait=True, cancel_futures=True)
    emit({"phase": "pileup_tools", "run": "all",
          "wall_s": round(time.perf_counter() - t_phase, 3)})
    return runs


# the view_tools phase: the CRAM runs' region of the cram phase's reads,
# wide enough (about 24,000 reads) that each half that cat joins holds
# two containers of the encoder's 10,000 records; those runs go as
# processes beside the in-process BAM runs, as the Python CRAM encoder
# costs about 0.4-1 ms a read (the phase's CRAM lines)
VIEW_CRAM_REGION = "sim1:1-80000"
VIEW_REGION = "sim1:1-1000000"
VIEW_EXPR = "pos > 1000000 && length(seq) >= 100"
CRAM_SLICE_RECORDS = 10_000

# one CRAM run of the view_tools phase as a process: the command through
# cli.main, then its output read back against the BAM twin's reads with
# lo <= pos < hi, and its data containers counted; a JSON report (its
# process wall from the parent's spawn)
VIEW_CHILD = r"""
import json, sys, time
import numpy as np
import torch
from samtools_tpu_torch import cli, kernels
from samtools_tpu_torch.io.cram import CramReader
from samtools_tpu_torch.io.files import read_alignments
report, spec = sys.argv[1], json.loads(sys.argv[2])
t0 = time.perf_counter()
rc = cli.main(spec["argv"])
res = {"rc": rc, "wall_s": time.perf_counter() - t0,
       "launches": {k: v for k, v in kernels.launches.items() if v}}
if rc == 0:
    twin = read_alignments(spec["twin"]).batch
    lo, hi = spec["pos"]
    want = twin.take(np.nonzero((twin.pos >= lo) & (twin.pos < hi))[0])
    t0 = time.perf_counter()
    got = read_alignments(spec["out"], reference=spec["fa"]).batch
    res["read_back_s"] = time.perf_counter() - t0
    res.update(reads=int(twin.n), reads_out=int(got.n), equal_records=bool(
        got.n == want.n and all(np.array_equal(getattr(got, k),
                                               getattr(want, k))
                                for k in spec["fields"])))
    with open(spec["out"], "rb") as f:
        res["containers"] = sum(
            1 for c, _ in CramReader(f.read()).containers() if c.n_records)
res["cuda_initialized"] = torch.cuda.is_initialized()
res["process_wall_s"] = time.time() - spec["t_spawn"]
with open(report, "w") as f:
    json.dump(res, f)
"""


def _same_records(a, b) -> bool:
    return a.n == b.n and all(np.array_equal(getattr(a, k), getattr(b, k))
                              for k in CRAM_FIELDS)


def _sam_records(text: bytes) -> bytes:
    """SAM text less its header lines."""
    i = 0
    while text.startswith(b"@", i):
        i = text.index(b"\n", i) + 1
    return text[i:]


def phase_view_tools(workdir: str, front: str, cram_bam: str) -> None:
    """view, head, flags, quickcheck and cat on clean's front and on the
    cram phase's reads (module doc, phase 16).  The phase launches no
    kernel."""
    import contextlib
    import io

    from samtools_tpu_torch import cli, kernels
    from samtools_tpu_torch.io import bgzf, native
    from samtools_tpu_torch.io.cram import CramReader
    from samtools_tpu_torch.io.files import read_alignments
    from samtools_tpu_torch.io.sam_text import format_record, parse_sam
    from samtools_tpu_torch.ops import filters
    t_phase = time.perf_counter()
    before = dict(kernels.launches)
    fa = os.path.join(workdir, "ref.fa")
    d = os.path.join(workdir, "view_tools")
    os.makedirs(d, exist_ok=True)
    p = lambda name: os.path.join(d, name)  # noqa: E731
    # the CRAM runs, as processes beside the BAM runs below: -C -T and
    # -O cram,version=3.1 on the region, and the two halves cat joins
    cend = int(VIEW_CRAM_REGION.split("-")[1])
    mid = cend // 2
    procs = {}
    for label, fmt, cond, pos in (
            ("view -C -T", ["-C"], None, (0, cend)),
            ("view -O cram,version=3.1", ["-O", "cram,version=3.1"], None,
             (0, cend)),
            ("view cram half 0", ["-C"], "pos <= %d" % mid, (0, mid)),
            ("view cram half 1", ["-C"], "pos > %d" % mid, (mid, cend))):
        k = len(procs)
        out = p(f"half{k - 2}.cram" if cond else f"c{k}.cram")
        spec = {"argv": ["view", *fmt, "-T", fa,
                         *(["-e", cond] if cond else []), "-o", out,
                         cram_bam, VIEW_CRAM_REGION],
                "out": out, "fa": fa, "twin": cram_bam, "pos": pos,
                "fields": list(CRAM_FIELDS), "t_spawn": time.time()}
        with open(p(f"child{k}.err"), "wb") as err:
            procs[label] = (subprocess.Popen(
                [sys.executable, "-c", VIEW_CHILD, p(f"child{k}.json"),
                 json.dumps(spec)], cwd=ROOT, stdin=subprocess.DEVNULL,
                stdout=subprocess.DEVNULL, stderr=err), k, out)
    whole = read_alignments(front, THREADS)
    n = whole.batch.n
    threads = str(THREADS)

    def run(label, argv, outs=(), reads=n, rc_ok=(0,)):
        """One in-process run; its stdout bytes, and a line: wall, reads a
        second, output bytes, launches (none allowed)."""
        raw = io.BytesIO()
        out = io.TextIOWrapper(raw, encoding="latin-1", write_through=True)
        b0 = dict(kernels.launches)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        launched = {k: v - b0[k] for k, v in kernels.launches.items()
                    if v != b0[k]}
        require(rc in rc_ok, f"{label}: rc {rc}")
        require(not launched, f"{label}: launched {launched}")
        size = len(raw.getvalue()) + sum(os.path.getsize(o) for o in outs)
        emit({"phase": "view_tools", "run": label, "reads": reads,
              "wall_s": round(wall, 3),
              "reads_per_s": round(reads / wall) if reads else None,
              "output_bytes": size, "launches": launched, "rc": rc})
        return raw.getvalue()

    # view -b: streamed, and through the whole-file path (-U)
    run("view -b (streamed)", ["view", "--no-PG", "-@", threads, "-b",
                               "-o", p("a.bam"), front], [p("a.bam")])
    run("view -b -U (whole file)", ["view", "--no-PG", "-@", threads, "-b",
                                    "-o", p("b.bam"), "-U", p("u.bam"),
                                    front], [p("b.bam"), p("u.bam")])
    with open(p("a.bam"), "rb") as f, open(p("b.bam"), "rb") as g:
        require(f.read() == g.read(),
                "view -b: the streamed and whole-file BAMs differ")
    require(read_alignments(p("u.bam")).batch.n == 0,
            "view -U wrote unselected reads")
    require(_same_records(read_alignments(p("a.bam"), THREADS).batch,
                          whole.batch), "view -b changed the records")
    # view -h to SAM, parsed back
    run("view -h (SAM)", ["view", "-h", "-o", p("a.sam"), front],
        [p("a.sam")])
    with open(p("a.sam"), "rb") as f:
        text = f.read()
    t0 = time.perf_counter()
    _, parsed = parse_sam(text)
    t_parse = time.perf_counter() - t0
    require(_same_records(parsed, whole.batch),
            "view -h: the SAM parses to other records than the BAM's")
    del parsed
    sam_recs = _sam_records(text)
    # the host library's formatter against format_record
    idx = np.arange(10_000, dtype=np.int64) * max(1, n // 10_000)
    hdr = whole.header
    names = np.frombuffer("".join(hdr.ref_names).encode(), np.uint8)
    noff = np.concatenate([[0], np.cumsum([len(x) for x in hdr.ref_names])
                           ]).astype(np.int64)
    t0 = time.perf_counter()
    fast = native.sam_format(whole.batch, idx, names, noff)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    slow = "".join(format_record(hdr, whole.batch, int(i)) + "\n"
                   for i in idx)
    t_python = time.perf_counter() - t0
    require(fast == slow, "the native SAM formatter differs from "
            "format_record")
    emit({"phase": "view_tools", "run": "parse_sam, sam_format",
          "reads": n, "parse_sam_s": round(t_parse, 3),
          "sam_bytes": len(text), "formatted_reads": int(idx.size),
          "native_s": round(t_native, 4), "python_s": round(t_python, 3),
          "byte_equal": True, "equal_records": True})
    del text
    # counts against numpy on the batch's columns
    b = whole.batch
    got = run("view -c -q 30 -F 0x10 -e", [
        "view", "-c", "-q", "30", "-F", "0x10", "-e", VIEW_EXPR, front])
    want = int(((b.mapq >= 30) & ((b.flag & 0x10) == 0) & (b.pos + 1 > 1e6)
                & (b.l_qseq >= 100)).sum())
    require(int(got) == want, f"view -c -e: {int(got)} != {want}")
    got = run("view -s 7.25 -c", ["view", "-s", "7.25", "-c", front])
    want = int(filters.subsample_keep(
        b, 0.25, filters.glibc_rand_first(7)).sum())
    require(int(got) == want and abs(want / n - 0.25) <= 0.01,
            f"view -s 7.25 -c: {int(got)}, {want} of {n}")
    # the other BAM and SAM forms, read back (the gzip'd SAM as text:
    # its records are view -h's lines)
    run("view -O sam.gz", ["view", "-@", threads, "-O", "sam.gz", "-h",
                           "-o", p("a.sam.gz"), front], [p("a.sam.gz")])
    with open(p("a.sam.gz"), "rb") as f:
        got = bgzf.decompress(f.read(), THREADS).tobytes()
    require(got.startswith(hdr.text.encode())
            and _sam_records(got) == sam_recs,
            "view -O sam.gz: other text than view -h")
    del got
    for label, argv, out in (("view -u", ["-u"], "u0.bam"),
                             ("view -1", ["-1"], "f1.bam")):
        run(label, ["view", "-@", threads, *argv, "-o", p(out), front],
            [p(out)])
        require(_same_records(read_alignments(p(out), THREADS).batch, b),
                f"{label}: the output reads back other records")
    # a region through the index the phase writes, against the
    # unindexed file's whole-file filter
    region = ["view", "-@", threads, "-b", "-o", p("r.bam"), front,
              VIEW_REGION]
    run("view -b region (no index)", region, [p("r.bam")])
    os.replace(p("r.bam"), p("r0.bam"))
    t0 = time.perf_counter()
    require(cli.main(["index", front]) == 0, "index failed")
    t_index = time.perf_counter() - t0
    # through the index the run reads only the region's records
    n_region = read_alignments(p("r0.bam"), THREADS).batch.n
    run("view -b region (index)", region, [p("r.bam")], reads=n_region)
    with open(p("r.bam"), "rb") as f, open(p("r0.bam"), "rb") as g:
        require(f.read() == g.read(),
                "view -r through the index differs from the whole file")
    emit({"phase": "view_tools", "run": "index", "reads": n,
          "wall_s": round(t_index, 3)})
    os.remove(front + ".bai")
    # head, flags
    got = run("head -n 1000", ["head", "-n", "1000", front])
    recs = b"".join(ln + b"\n" for ln in sam_recs.split(b"\n", 1000)[:1000])
    require(got == hdr.text.encode() + recs,
            "head -n 1000 differs from view's first records")
    del sam_recs
    got = run("flags 0x63", ["flags", "0x63"], reads=0)
    require(got == b"0x63\t99\tPAIRED,PROPER_PAIR,MREVERSE,READ1\n",
            f"flags 0x63: {got!r}")
    # cat of halves that view wrote: BAM here; CRAM from the processes
    halves = []
    for k, cond in enumerate(("pos <= %d", "pos > %d")):
        out = p(f"half{k}.bam")
        run(f"view bam half {k}", ["view", "-b", "-@", threads, "-e",
                                   cond % 1_000_000, "-o", out, front],
            [out])
        halves.append(out)
    run("cat (BAM)", ["cat", "-o", p("cat.bam"), *halves], [p("cat.bam")])
    require(_same_records(read_alignments(p("cat.bam"), THREADS).batch, b),
            "cat (BAM): the halves are not the whole")
    # the CRAM processes: each read back equal, no kernel, no CUDA
    # context; each half of at least two containers
    res = {}
    for label, (proc, k, out) in procs.items():
        rc = proc.wait(timeout=600)
        with open(p(f"child{k}.err"), "rb") as f:
            err = f.read().decode("latin-1")[-500:]
        require(rc == 0 and os.path.exists(p(f"child{k}.json")),
                f"{label}: process rc {rc}: {err}")
        with open(p(f"child{k}.json")) as f:
            r = json.load(f)
        require(r["rc"] == 0, f"{label}: rc {r['rc']}: {err}")
        require(r["equal_records"],
                f"{label}: the CRAM reads back other records")
        require(not r["launches"] and not r["cuda_initialized"],
                f"{label}: launched {r['launches']}, CUDA context "
                f"{r['cuda_initialized']}")
        res[label] = r
        emit({"phase": "view_tools", "run": label, "reads": r["reads"],
              "reads_out": r["reads_out"], "wall_s": round(r["wall_s"], 3),
              "reads_per_s": round(r["reads"] / r["wall_s"]),
              "process_wall_s": round(r["process_wall_s"], 3),
              "read_back_s": round(r["read_back_s"], 3),
              "containers": r["containers"],
              "output_bytes": os.path.getsize(out), "launches": {},
              "rc": 0})
    nc = res["view -C -T"]["reads_out"]
    for label in ("view cram half 0", "view cram half 1"):
        require(res[label]["containers"] >= 2
                and res[label]["reads_out"] > CRAM_SLICE_RECORDS,
                f"{label}: {res[label]['containers']} containers, "
                f"{res[label]['reads_out']} reads; cat would splice no "
                "container boundary")
    halves = [p("half0.cram"), p("half1.cram")]
    run("cat (CRAM)", ["cat", "-o", p("cat.cram"), *halves],
        [p("cat.cram")], reads=nc)
    t0 = time.perf_counter()
    tw = read_alignments(cram_bam, THREADS).batch
    creads = tw.take(np.nonzero(tw.pos < cend)[0])
    got = read_alignments(p("cat.cram"), THREADS, reference=fa).batch
    require(_same_records(got, creads),
            "cat (CRAM): the halves are not the whole")
    with open(p("cat.cram"), "rb") as f:
        n_cont = sum(1 for c, _ in CramReader(f.read()).containers()
                     if c.n_records)
    require(n_cont == res["view cram half 0"]["containers"]
            + res["view cram half 1"]["containers"],
            f"cat (CRAM): {n_cont} containers, not the halves' sum")
    emit({"phase": "view_tools", "run": "cat (CRAM) read back",
          "reads": nc, "containers": n_cont,
          "wall_s": round(time.perf_counter() - t0, 3)})
    # quickcheck: every output, then a copy cut by 100 bytes
    outs = sorted(os.path.join(d, x) for x in os.listdir(d)
                  if x.endswith((".bam", ".cram", ".sam", ".sam.gz")))
    run("quickcheck -v (outputs)", ["quickcheck", "-v", *outs], reads=0)
    with open(p("a.bam"), "rb") as f:
        body = f.read()
    with open(p("cut.bam"), "wb") as f:
        f.write(body[:-100])
    got = run("quickcheck -v (cut)", ["quickcheck", "-v", p("cut.bam")],
              reads=0, rc_ok=tuple(range(1, 256)))
    require(got == (p("cut.bam") + "\n").encode(),
            f"quickcheck on the cut copy printed {got!r}")
    require(kernels.launches == before,
            "the view_tools phase launched a kernel")
    for x in os.listdir(d):
        os.remove(os.path.join(d, x))
    os.rmdir(d)
    emit({"phase": "view_tools", "run": "all", "reads": n,
          "cram_reads": nc, "wall_s": round(time.perf_counter() - t_phase,
                                            3)})


# the prep_tools phase: its front (clean's reads that start before this:
# the sorts of the phase on clean's whole 2 Mbp front would take it past
# its ~45 s), the share of the front's reads made unplaced for sort -M
# and -I, and the spill runs sort -m must reach
PREP_FRONT_END = 1_000_000
PREP_UNPLACED_EVERY = 10
PREP_SPILL_RUNS = 6

# the front's reads that calmd -r realigns, one at a time, in the HMM
# process of the prep_tools phase
PREP_REALN_READS = 2000

# the host-command processes of the prep_tools phase (beside the front's
# runs: the pairs' chain, collate, fixmate -m, sort, sort -n, markdup -S
# and rmdup; calmd -r on the front's first reads) and of the
# realign_tools phase: runs through cli.main, each run's standard output
# into a file when one is named (and its standard error when a fourth
# element names one); a JSON report of each run's wall, exit code and
# launches, whether the process made a CUDA context, and what
# core/malloc_tune.tune() gave.  Where the spec's ``before`` names a
# function of this script for a run (its name and arguments), the process
# calls it first: the amplicon_tools phase's simulate_amplicon_samples,
# the ancillary_tools phase's write_eval_inputs and write_ace_sam, which
# need not run in this script's own process, whose wall is the limit's
PREP_CHILD = r"""
import contextlib, importlib, io, json, sys, time
import torch
from samtools_tpu_torch import cli, kernels
from samtools_tpu_torch.core.malloc_tune import tune
report, spec = sys.argv[1], json.loads(sys.argv[2])
before = spec.get("before") or {}
runs = []
for label, argv, stdout, *stderr in spec["runs"]:
    if label in before:
        fn, args = before[label]
        getattr(importlib.import_module("chip_smoke"), fn)(*args)
    b0 = dict(kernels.launches)
    t0 = time.perf_counter()
    with contextlib.ExitStack() as st:
        for path, redirect in ((stdout, contextlib.redirect_stdout),
                               (stderr and stderr[0],
                                contextlib.redirect_stderr)):
            if path:
                st.enter_context(redirect(io.TextIOWrapper(
                    st.enter_context(open(path, "wb")), encoding="latin-1",
                    write_through=True)))
        rc = cli.main(argv)
    runs.append({"run": label, "rc": rc,
                 "wall_s": time.perf_counter() - t0,
                 "launches": {k: v - b0.get(k, 0)
                              for k, v in kernels.launches.items()
                              if v != b0.get(k, 0)}})
    if rc:
        break
with open(report, "w") as f:
    json.dump({"runs": runs, "cuda_initialized": torch.cuda.is_initialized(),
               "tune": tune(),
               "process_wall_s": time.time() - spec["t_spawn"]}, f)
"""


def spawn_cli_child(d: str, name: str, runs: list, env: dict | None = None,
                    before: dict | None = None):
    """A PREP_CHILD process of ``runs`` (label, argv, stdout file[,
    stderr file]), its report to ``d/<name>.json`` and its stderr to
    ``d/<name>.err``, with ``env`` added to its environment, that calls
    ``before``'s functions (run label -> [function of this script,
    arguments]) before their runs; killed at exit if a failed check
    leaves it running."""
    with open(os.path.join(d, name + ".err"), "wb") as err:
        proc = subprocess.Popen(
            [sys.executable, "-c", PREP_CHILD,
             os.path.join(d, name + ".json"),
             json.dumps({"runs": runs, "t_spawn": time.time(),
                         "before": before})],
            cwd=ROOT, stdin=subprocess.DEVNULL,
            stdout=subprocess.DEVNULL, stderr=err,
            env={**os.environ, **(env or {})})
    atexit.register(proc.kill)
    return proc


def wait_cli_child(proc, d: str, name: str, what: str, runs: list):
    """Wait for a spawn_cli_child process: it exits 0 without a CUDA
    context, and each of ``runs`` ran to rc 0 with no launch.  Its report
    and its stderr."""
    rc = proc.wait(timeout=600)
    with open(os.path.join(d, name + ".err"), "rb") as f:
        err = f.read().decode("latin-1")
    report = os.path.join(d, name + ".json")
    require(rc == 0 and os.path.exists(report),
            f"{what}: process rc {rc}: {err[-500:]}")
    with open(report) as f:
        res = json.load(f)
    require(not res["cuda_initialized"], f"{what} made a CUDA context")
    require(len(res["runs"]) == len(runs), f"{what}: {err[-500:]}")
    for r, (label, *_) in zip(res["runs"], runs):
        require(r["rc"] == 0 and not r["launches"],
                f"{label}: rc {r['rc']}, launched {r['launches']}: "
                f"{err[-500:]}")
    return res, err


def _name_rows(b) -> np.ndarray:
    """The batch's qnames as one fixed-width bytes value each (the
    simulated names are all one width, so byte order is the natural
    order)."""
    w = np.diff(b.qname_off)
    require(b.n == 0 or (w == w[0]).all(), "names of several widths")
    return b.qname.reshape(b.n, -1).view(f"S{int(w[0]) if b.n else 1}")[:, 0]


def _coordinate_sorted(b) -> bool:
    """(tid with unmapped last, pos) never decreases."""
    tid = np.where(b.tid < 0, np.iinfo(np.int64).max, b.tid.astype(np.int64))
    return bool(np.all((tid[1:] > tid[:-1])
                       | ((tid[1:] == tid[:-1]) & (b.pos[1:] >= b.pos[:-1]))))


def _templates_adjacent(b) -> bool:
    """Each template's records lie together: as many runs of equal names
    as distinct names."""
    names = _name_rows(b)
    runs = 1 + int(np.count_nonzero(names[1:] != names[:-1])) if b.n else 0
    return runs == np.unique(names).size


def _template_order(b) -> bool:
    """template-coordinate on single-end reads without clips or hard
    clips: (tid, the 5' end's unclipped position, reverse before
    forward) never decreases."""
    require(not (b.flag & 1).any() and not np.isin(b.cigar & 0xF,
                                                   (4, 5)).any(),
            "the template check takes single-end reads without clips")
    rev = (b.flag & 0x10) != 0
    p1 = np.where(rev, b.end_pos(), b.pos + 1).astype(np.int64)
    key = np.stack([b.tid.astype(np.int64), p1, (~rev).astype(np.int64)])
    d = key[:, 1:] - key[:, :-1]
    first = np.argmax(d != 0, axis=0)
    return bool(np.all(d[first, np.arange(d.shape[1])] >= 0))


def _md_nm_check(path: str, n: int, ref: np.ndarray, ref_end: int) -> int:
    """calmd -b's BAM at ``path``, of the front's ``n`` all-M reads: every
    read has NM:i and MD:Z; where it ends inside the FASTA (by
    ``ref_end``), NM is numpy's count of its mismatches to ``ref`` and
    its MD names as many bases.  Returns the reads held to numpy."""
    from samtools_tpu_torch.io import native
    from samtools_tpu_torch.io.files import read_alignments
    from samtools_tpu_torch.io.sam_text import NT16_LUT
    out = read_alignments(path, THREADS).batch
    L = int(out.l_qseq[0]) if out.n else 0
    require(out.n == n and (out.cigar & 0xF == 0).all()
            and (out.l_qseq == L).all(),
            "calmd -b: not the front's all-M reads of one length")
    idx = np.arange(n, dtype=np.int64)
    nm_off, nm_t = native.aux_find_batch(out.aux, out.aux_off, idx, "NM")
    md_off, md_t = native.aux_find_batch(out.aux, out.aux_off, idx, "MD")
    require((nm_t == ord("i")).all() and (md_t == ord("Z")).all(),
            "calmd -b: a read without its NM:i or MD:Z")
    nm = out.aux[nm_off[:, None] + np.arange(4)].copy().view("<i4")[:, 0]
    inside = np.nonzero(out.end_pos() <= ref_end)[0]
    seq = out.seq.reshape(n, L)[inside]
    want = NT16_LUT[ref[out.pos[inside, None] + np.arange(L)]]
    mism = (seq != want).sum(axis=1)
    require(np.array_equal(nm[inside], mism),
            "calmd -b: NM differs from numpy's mismatch count")
    flat = out.aux.tobytes()
    letters = [len(flat[o:flat.index(b"\0", o)].translate(None,
                                                          b"0123456789"))
               for o in md_off[inside].tolist()]
    require(np.array_equal(letters, mism),
            "calmd -b: MD names other bases than NM counts")
    return int(inside.size)


def phase_prep_tools(workdir: str, clean_front: str, pairs: str,
                     ref: np.ndarray) -> None:
    """collate, fixmate, sort, merge, markdup, rmdup, calmd and
    addreplacerg (module doc, phase 17): the pairs' chain and calmd -r in
    processes, the front's other runs in-process; no kernel."""
    import contextlib
    import io

    from samtools_tpu_torch import cli, kernels
    from samtools_tpu_torch.io.bam import write_bam
    from samtools_tpu_torch.io.extsort import batch_nbytes
    from samtools_tpu_torch.io.files import read_alignments
    t_phase = time.perf_counter()
    before = dict(kernels.launches)
    d = os.path.join(workdir, "prep_tools")
    os.makedirs(d, exist_ok=True)
    p = lambda name: os.path.join(d, name)  # noqa: E731
    threads = str(THREADS)

    # the pairs' chain, beside the front's runs
    chain = [("collate", ["collate", "-@", threads, "-o", p("g.bam"),
                          pairs], None),
             ("fixmate -m", ["fixmate", "-@", threads, "-m", p("g.bam"),
                             p("fm.bam")], None),
             ("sort (pairs)", ["sort", "-@", threads, "-o", p("fs.bam"),
                               p("fm.bam")], None),
             ("sort -n (pairs)", ["sort", "-@", threads, "-n", "-o",
                                  p("fn.bam"), p("fm.bam")], None),
             ("markdup -S (pairs)", ["markdup", "-@", threads, "-S", "-s",
                                     "-f", p("md.txt"), p("fs.bam"),
                                     p("md.bam")], None),
             ("rmdup (pairs)", ["rmdup", p("fs.bam"), p("rd.bam")], None)]
    child = spawn_cli_child(d, "child", chain)
    # the front at the phase's depth, and a copy with one read in
    # PREP_UNPLACED_EVERY unmapped (sort -M and -I cluster those)
    got = read_alignments(clean_front, THREADS)
    keep = np.nonzero(got.batch.pos < PREP_FRONT_END)[0]
    b = got.batch.take(keep)
    n = b.n
    front = p("front.bam")
    write_bam(front, got.header, b, threads=THREADS)
    um = np.arange(n) % PREP_UNPLACED_EVERY == 0
    u = b.take(np.arange(n))
    u.tid[um], u.pos[um] = -1, -1
    u.flag[um] |= 0x4
    unplaced = p("unplaced.bam")
    write_bam(unplaced, got.header, u, threads=THREADS)
    header = got.header
    del got, u
    fa = p("front.fa")
    write_fasta(fa, ref[:PREP_FRONT_END])
    # calmd -r's HMM, a read at a time, on the front's first reads
    write_bam(p("front2k.bam"), header, b.take(np.arange(PREP_REALN_READS)),
              threads=THREADS)
    realn = [("calmd -r", ["calmd", "-r", p("front2k.bam"), fa],
              p("calmd_r.sam"))]
    hmm = spawn_cli_child(d, "hmm", realn)

    def run(label, argv, outs=(), reads=n):
        """One in-process run: its stdout and stderr, and a line of wall,
        reads a second, output bytes and launches (none allowed)."""
        raw, err = io.BytesIO(), io.StringIO()
        out = io.TextIOWrapper(raw, encoding="latin-1", write_through=True)
        b0 = dict(kernels.launches)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = cli.main(argv)
        wall = time.perf_counter() - t0
        launched = {k: v - b0[k] for k, v in kernels.launches.items()
                    if v != b0[k]}
        require(rc == 0, f"{label}: rc {rc}: {err.getvalue()[-500:]}")
        require(not launched, f"{label}: launched {launched}")
        emit({"phase": "prep_tools", "run": label, "reads": reads,
              "wall_s": round(wall, 3),
              "reads_per_s": round(reads / wall) if reads else None,
              "output_bytes": len(raw.getvalue()) + sum(
                  os.path.getsize(o) for o in outs), "launches": {}})
        return raw.getvalue(), err.getvalue()

    def records(path):
        return read_alignments(path, THREADS).batch

    # in memory, then spilled to PREP_SPILL_RUNS runs: the same bytes
    run("sort", ["sort", "--no-PG", "-@", threads, "-o", p("mem.bam"),
                 front], [p("mem.bam")])
    mem = records(p("mem.bam"))
    require(mem.n == n and _coordinate_sorted(mem), "sort: not in order")
    arena = batch_nbytes(b) // (PREP_SPILL_RUNS * THREADS)
    _, err = run("sort -m (spilled)", [
        "sort", "--no-PG", "-@", threads, "--verbosity", "4", "-m",
        str(arena), "-T", p("spill"), "-o", p("spill.bam"), front],
        [p("spill.bam")])
    spills = int(err.split("[I::sort] merging from ")[1].split()[0])
    with open(p("mem.bam"), "rb") as f, open(p("spill.bam"), "rb") as g:
        require(f.read() == g.read(),
                "sort -m: the spilled run's bytes differ from in-memory")
    require(spills >= 4, f"sort -m spilled {spills} runs, not 4 or more")
    require(not [x for x in os.listdir(d) if x.startswith("spill.0")],
            "sort -m left a spill run behind")
    emit({"phase": "prep_tools", "run": "sort -m runs", "arena_bytes": arena,
          "threads": THREADS, "spill_runs": spills, "byte_equal": True})
    # an index written beside the sort, read by idxstats
    run("sort --write-index", ["sort", "-@", threads, "--write-index", "-o",
                               p("idx.bam"), front], [p("idx.bam")])
    got, _ = run("idxstats", ["idxstats", p("idx.bam")], reads=n)
    mapped = sum(int(ln.split(b"\t")[2]) for ln in got.splitlines())
    require(mapped == n, f"idxstats: {mapped} mapped reads of {n}")
    # minimisers: the mapped reads in coordinate order, the unplaced ones
    # last with their key fields cleared
    for label, extra in (("sort -M", ["-M"]), ("sort -I", ["-I", fa])):
        out = p(label[-1] + ".bam")
        run(label, ["sort", "-@", threads, *extra, "-o", out, unplaced],
            [out])
        m = records(out)
        k = int(um.sum())
        require(m.n == n and (m.tid[n - k:] < 0).all()
                and _coordinate_sorted(m.take(np.arange(n - k)))
                and (m.pos[n - k:] == -1).all(),
                f"{label}: not in minimiser order")
    run("sort --template-coordinate", [
        "sort", "-@", threads, "--template-coordinate", "-o", p("t.bam"),
        front], [p("t.bam")])
    require(_template_order(records(p("t.bam"))),
            "sort --template-coordinate: not in order")
    # merge of the halves that view -e splits off: the whole sort's records
    mid = PREP_FRONT_END // 2
    halves = []
    for k, cond in enumerate(("pos < %d", "pos >= %d")):
        halves.append(p(f"half{k}.bam"))
        run(f"view -e half {k}", ["view", "-b", "-@", threads, "-e",
                                  cond % mid, "-o", halves[-1],
                                  p("mem.bam")], [halves[-1]])
    run("merge", ["merge", "-@", threads, "-c", "-p", "-o", p("merged.bam"),
                  *halves], [p("merged.bam")])
    require(_same_records(records(p("merged.bam")), mem),
            "merge: the halves are not the whole sort")
    # calmd -b: NM and MD on every read, NM held to numpy's count
    raw, _ = run("calmd -b", ["calmd", "-@", threads, "-b", front, fa])
    with open(p("calmd.bam"), "wb") as f:
        f.write(raw)
    held = _md_nm_check(p("calmd.bam"), n, ref, PREP_FRONT_END)
    emit({"phase": "prep_tools", "run": "calmd -b check", "reads": n,
          "nm_held_to_numpy": held})
    # addreplacerg: the new @RG line, and every read in it
    run("addreplacerg", ["addreplacerg", "-@", threads, "-r",
                         "@RG\\tID:x\\tSM:y", "-o", p("rg.bam"), front],
        [p("rg.bam")])
    rg = read_alignments(p("rg.bam"), THREADS)
    require([ln for ln in rg.header.lines() if ln.startswith("@RG")]
            == ["@RG\tID:x\tSM:y"]
            and rg.batch.aux.tobytes().count(b"RGZx\0") == n,
            "addreplacerg: a read outside the new read group")
    del rg

    def child_runs(proc, name, what, runs, reads):
        """Wait for a PREP_CHILD process (wait_cli_child), a line a run;
        its report and stderr."""
        res, err = wait_cli_child(proc, d, name, what, runs)
        for r, (label, argv, stdout) in zip(res["runs"], runs):
            out = stdout or (argv[argv.index("-o") + 1] if "-o" in argv
                             else argv[-1])
            emit({"phase": "prep_tools", "run": label, "reads": reads,
                  "wall_s": round(r["wall_s"], 3),
                  "reads_per_s": round(reads / r["wall_s"]),
                  "output_bytes": os.path.getsize(out), "launches": {},
                  "process": True})
        return res, err

    # the pairs' chain
    n_pairs = records(pairs).n
    res, err = child_runs(child, "child", "the pairs' chain", chain, n_pairs)
    g = records(p("g.bam"))
    require(g.n == n_pairs and _templates_adjacent(g),
            "collate: a template's records are apart")
    fm = records(p("fm.bam"))
    flat = fm.aux.tobytes()
    require(fm.n == n_pairs and all(flat.count(t) == n_pairs
                                    for t in (b"MQi", b"MCZ", b"msi")),
            "fixmate -m: a read without its MQ, MC or ms tag")
    fs = records(p("fs.bam"))
    require(fs.n == n_pairs and _coordinate_sorted(fs),
            "sort (pairs): not in order")
    fn = records(p("fn.bam"))
    names = _name_rows(fn)
    require(fn.n == n_pairs and bool(np.all(names[1:] >= names[:-1]))
            and not ((names[1:] == names[:-1])
                     & ((fn.flag[:-1] & 0x80) != 0)).any(),
            "sort -n (pairs): not in name order, READ1 first")
    # markdup: the reads flagged are the stats file's total; its spill
    # file is gone.  rmdup: between one and two reads a duplicate pair
    # removed
    md = records(p("md.bam"))
    with open(p("md.txt")) as f:
        mstats = dict(ln.rstrip("\n").split(": ", 1) for ln in f
                      if ": " in ln)
    flagged = int(np.count_nonzero(md.flag & 0x400))
    require(md.n == n_pairs and int(mstats["READ"]) == n_pairs
            and int(mstats["DUPLICATE TOTAL"]) == flagged,
            f"markdup -S: {flagged} reads flagged, the stats say "
            f"{mstats.get('DUPLICATE TOTAL')}")
    require(not [x for x in os.listdir(d) if ".supp." in x],
            "markdup -S left its spill file behind")
    removed = sum(int(ln.split()[1]) for ln in err.splitlines()
                  if ln.startswith("[bam_rmdup_core]") and " / " in ln)
    rd = records(p("rd.bam"))
    require(fs.n - 2 * removed <= rd.n <= fs.n - removed
            and _coordinate_sorted(rd),
            f"rmdup: {rd.n} reads left of {fs.n}, {removed} pairs removed")
    emit({"phase": "prep_tools", "run": "markdup -S, rmdup checks",
          "reads": n_pairs, "duplicates_flagged": flagged,
          "rmdup_pairs_removed": removed, "rmdup_reads_left": rd.n})
    del g, fm, fs, fn, md, rd
    # calmd -r: a BQ tag on every read, none below '@' (all-M reads)
    hres, _ = child_runs(hmm, "hmm", "calmd -r", realn, PREP_REALN_READS)
    with open(p("calmd_r.sam"), "rb") as f:
        recs = [ln for ln in f.read().split(b"\n")
                if ln and not ln.startswith(b"@")]
    bq = [ln.split(b"\tBQ:Z:")[1].split(b"\t")[0] for ln in recs
          if b"\tBQ:Z:" in ln]
    require(len(recs) == len(bq) == PREP_REALN_READS
            and min(min(x) for x in bq) >= ord("@"),
            f"calmd -r: {len(bq)} BQ tags on {len(recs)} reads")
    # quickcheck every output
    outs = sorted(os.path.join(d, x) for x in os.listdir(d)
                  if x.endswith(".bam"))
    run("quickcheck (outputs)", ["quickcheck", *outs], reads=0)
    require(kernels.launches == before,
            "the prep_tools phase launched a kernel")
    for x in os.listdir(d):
        os.remove(os.path.join(d, x))
    os.rmdir(d)
    emit({"phase": "prep_tools", "run": "all", "reads": n,
          "pairs_reads": n_pairs,
          "child_process_wall_s": round(res["process_wall_s"], 3),
          "hmm_process_wall_s": round(hres["process_wall_s"], 3),
          "wall_s": round(time.perf_counter() - t_phase, 3)})


# the amplicon_tools phase: samples of the ARTIC-shaped panel
# (sim.amplicon_panel), their reads, and the first sample's seed
AMPLICON_SAMPLES = 4
AMPLICON_READS = 50_000
AMPLICON_SEED = 43

def simulate_amplicon_samples(d: str) -> None:
    """The amplicon process's first step: the samples simulated and
    written to ``d``, with each record's amplicon and each amplicon's
    left primers (the panel the samples share) kept for the checks, and
    the time it took in ``d/sim.json``."""
    from samtools_tpu_torch import sim
    from samtools_tpu_torch.io.bam import write_bam
    t_sim = time.perf_counter()
    for k in range(AMPLICON_SAMPLES):
        panel = sim.amplicon_panel(AMPLICON_READS, AMPLICON_SEED + k,
                                   sample=f"s{k}")
        write_bam(os.path.join(d, f"s{k}.bam"), panel.header, panel.batch)
        np.save(os.path.join(d, f"amp{k}.npy"), panel.amplicon)
    with open(os.path.join(d, "primers.bed"), "w") as f:
        f.write(panel.bed)
    np.save(os.path.join(d, "left_ends.npy"),
            np.array([min(r for _, r in x) for x in panel.lefts]))
    with open(os.path.join(d, "sim.json"), "w") as f:
        json.dump({"sim_s": time.perf_counter() - t_sim}, f)


def _clip_report(path: str) -> dict:
    """An ampliconclip stats file as {field: number}, the command left
    out."""
    with open(path) as f:
        return {k: int(v) for k, v in (ln.rstrip("\n").split(": ", 1)
                                       for ln in f)
                if k != "COMMAND"}


def _record_keys(b) -> np.ndarray:
    """(qname, READ1/READ2/secondary/supplementary bits) of each record,
    what ampliconclip leaves as it was, as one structured value each."""
    names = _name_rows(b)
    keys = np.empty(b.n, [("name", names.dtype), ("bits", np.uint16)])
    keys["name"] = names
    keys["bits"] = b.flag & 0x9C0
    return keys


def _query_len(cigar) -> int:
    """The bases a SAM CIGAR string's M, I, S, = and X ops hold."""
    return sum(int(n) for n, op in re.findall(r"(\d+)([MIDNSHP=X])", cigar)
               if op in "MIS=X")


def start_amplicon_tools(workdir: str):
    """ampliconclip, sort and ampliconstats, the viral amplicon path
    (module doc, phase 18): starts the process, which simulates the
    samples and runs the commands, and returns what waits for it and
    checks its outputs against the simulator's truth in numpy.  No
    kernel, no CUDA context.  plot-ampliconstats and plot-bamstats do
    not run here: they draw with matplotlib, which the card's machine
    does not list (the CPU tests hold them to the JAX tool)."""
    t_phase = time.perf_counter()
    d = os.path.join(workdir, "amplicon_tools")
    os.makedirs(d, exist_ok=True)
    p = lambda name: os.path.join(d, name)  # noqa: E731
    bed = p("primers.bed")
    runs = []
    for k in range(AMPLICON_SAMPLES):
        runs.append((f"ampliconclip s{k}", [
            "ampliconclip", "--both-ends", "--strand", "--primer-counts",
            p(f"pc{k}.txt"), "--rejects-file", p(f"rej{k}.bam"),
            "--filter-len", "30", "-f", p(f"st{k}.txt"), "-b", bed, "-o",
            p(f"clip{k}.bam"), p(f"s{k}.bam")], None))
    runs.append(("ampliconclip --hard-clip", [
        "ampliconclip", "--hard-clip", "--original", "--fail",
        "--tolerance", "3", "-O", "sam", "-f", p("hard.txt"), "-b", bed,
        p("s0.bam")], p("hard.sam")))
    for k in range(AMPLICON_SAMPLES):
        runs.append((f"sort s{k}", ["sort", "-o", p(f"sorted{k}.bam"),
                                    p(f"clip{k}.bam")], None))
    runs.append(("ampliconstats -s", [
        "ampliconstats", "-s", "-o", p("astats.txt"), bed,
        *[p(f"sorted{k}.bam") for k in range(AMPLICON_SAMPLES)]], None))
    proc = spawn_cli_child(d, "amplicon", runs, before={
        runs[0][0]: ["simulate_amplicon_samples", [d]]})

    def finish() -> None:
        from samtools_tpu_torch import kernels
        from samtools_tpu_torch.io.files import read_alignments
        before = dict(kernels.launches)
        res, _ = wait_cli_child(proc, d, "amplicon", "the amplicon process",
                                runs)
        with open(p("sim.json")) as f:
            sim_s = json.load(f)["sim_s"]
        n = AMPLICON_READS
        left_end = np.load(p("left_ends.npy"))
        passing = []
        for k in range(AMPLICON_SAMPLES):
            st = _clip_report(p(f"st{k}.txt"))
            require(st["TOTAL READS"] == n
                    and st["TOTAL READS"] == st["WRITTEN"] + st["FILTERED"],
                    f"ampliconclip s{k}: TOTAL is not WRITTEN + FILTERED")
            with open(p(f"pc{k}.txt")) as f:
                counted = sum(int(ln.split("\t")[6]) for ln in f
                              if not ln.startswith("#"))
            require(counted == st["FORWARD CLIPPED"] + st["REVERSE CLIPPED"],
                    f"ampliconclip s{k}: the primer counts add up to "
                    f"{counted}, not FORWARD + REVERSE CLIPPED")
            b = read_alignments(p(f"s{k}.bam"), THREADS).batch
            out = read_alignments(p(f"clip{k}.bam"), THREADS).batch
            rej = read_alignments(p(f"rej{k}.bam"), THREADS).batch
            keys, kout = _record_keys(b), _record_keys(out)
            order = np.argsort(keys)
            require(out.n == st["WRITTEN"] and rej.n == st["FILTERED"]
                    and np.array_equal(np.sort(np.concatenate(
                        [kout, _record_keys(rej)])), keys[order]),
                    f"ampliconclip s{k}: the output and the rejects do not "
                    "hold every input read once")
            # each soft-clipped forward read starts at or past a left
            # primer of its amplicon
            src = order[np.searchsorted(keys[order], kout)]
            amp = np.load(p(f"amp{k}.npy"))[src]
            fwd = (amp >= 0) & ((b.flag[src] & 0x14) == 0) \
                & ((out.flag & 0x4) == 0)
            moved = fwd & (out.pos != b.pos[src])
            require(moved.sum() > 0.5 * fwd.sum() and bool(np.all(
                out.pos[moved] >= left_end[amp[moved]])),
                    f"ampliconclip s{k}: a clipped forward read starts "
                    "inside its primer")
            s = read_alignments(p(f"sorted{k}.bam"), THREADS).batch
            require(s.n == out.n and _coordinate_sorted(s),
                    f"sort s{k}: not the clipped reads in order")
            ends = s.pos + np.where(((s.flag & 0x4) == 0) & (s.n_cigar > 0),
                                    s.ref_span(), 1)
            passing.append(int(np.count_nonzero(
                (s.tid >= 0) & ((s.flag & 0xB04) == 0) & (ends != s.pos))))
            del b, out, rej, s
        # the hard clip: an OA tag on each clipped read, bases as many as
        # its CIGAR holds, QC-fail on the unclipped ones
        hard = _clip_report(p("hard.txt"))
        with open(p("hard.sam")) as f:
            recs = [ln.rstrip("\n").split("\t") for ln in f
                    if not ln.startswith("@")]
        oa = [r for r in recs if any(x.startswith("OA:Z:") for x in r[11:])]
        require(len(recs) == hard["WRITTEN"]
                and len(oa) == hard["TOTAL CLIPPED"]
                and all(r[5] == "*" or _query_len(r[5]) == len(r[9])
                        for r in oa)
                and hard["FAILED"] >= hard["NOT CLIPPED"] > 0,
                "ampliconclip --hard-clip: OA tags, bases or QC-fail flags "
                "off")
        # ampliconstats: each sample's reads that pass -F are its FREADS
        # plus its failed primer matches; COMBINED is the sum of the four
        with open(p("astats.txt")) as f:
            rows = [ln.rstrip("\n").split("\t") for ln in f]
        freads = {r[1]: list(map(int, r[2:])) for r in rows
                  if r[0] == "FREADS"}
        fss = {(r[1], r[3]): int(r[4]) for r in rows if r[0] == "FSS"}
        for k in range(AMPLICON_SAMPLES):
            name = f"s{k}"
            require(sum(freads[name]) == fss[(name, "matching sequences:")]
                    and sum(freads[name]) + fss[(name,
                                                 "failed primer match:")]
                    == passing[k],
                    f"ampliconstats: {name}'s FREADS are not its reads that "
                    "pass -F")
        comb = [list(map(int, r[2:])) for r in rows
                if r[:2] == ["CREADS", "COMBINED"]][0]
        css = {r[3]: int(r[4]) for r in rows if r[0] == "CSS"}
        require(comb == [sum(x) for x in zip(*freads.values())]
                and css["raw total sequences:"] == sum(
                    fss[(f"s{k}", "raw total sequences:")]
                    for k in range(AMPLICON_SAMPLES)),
                "ampliconstats: COMBINED is not the sum of the samples")
        require(kernels.launches == before,
                "the amplicon_tools phase launched a kernel")
        # the reads each run reads: a sample, its clipped reads, or all
        # four samples' clipped reads
        written = [_clip_report(p(f"st{k}.txt"))["WRITTEN"]
                   for k in range(AMPLICON_SAMPLES)]
        for r, (label, _, _) in zip(res["runs"], runs):
            k = (sum(written) if label.startswith("ampliconstats")
                 else written[int(label[-1])] if label.startswith("sort")
                 else n)
            emit({"phase": "amplicon_tools", "run": label, "reads": k,
                  "wall_s": round(r["wall_s"], 3),
                  "reads_per_s": round(k / r["wall_s"]), "launches": {},
                  "process": True})
        for x in os.listdir(d):
            os.remove(os.path.join(d, x))
        os.rmdir(d)
        emit({"phase": "amplicon_tools", "run": "all",
              "samples": AMPLICON_SAMPLES, "reads": n,
              "matching_reads": [fss[(f"s{k}", "matching sequences:")]
                                 for k in range(AMPLICON_SAMPLES)],
              "sim_s": round(sim_s, 3),
              "process_wall_s": round(res["process_wall_s"], 3),
              "wall_s": round(time.perf_counter() - t_phase, 3)})
    return finish


# the ancillary_tools phase: wgsim's pairs on clean's first ANC_FRONT
# bases (its seed and pairs), every ANC_MOVE_EVERY-th record of the
# evaluation SAM moved ANC_MOVE bases away at MAPQ ANC_MOVE_MAPQ, and the
# seed of the ACE that ace2sam converts
ANC_FRONT = 2_000_000
ANC_SEED = 11
ANC_PAIRS = 20_000
ANC_READ_LEN = 100
ANC_MOVE_EVERY = 10
ANC_MOVE = 10_000
ANC_MOVE_MAPQ = 10
ANC_ACE_SEED = 37
# fasta-sanitize's input: names with characters outside SAM's RNAME
# alphabet, first and later ones
ANC_BAD_NAMES = ("*star", "=equal", "has space", "a<b>c", "x,y(z)",
                 "ok_name", "tab\there", "quote'd\"", "[br]{ace}")
_RNAME = re.compile(r"^[0-9A-Za-z!#$%&+./:;?@^_|~-][0-9A-Za-z!#$%&*+./:;=?@"
                    r"^_|~-]*$")
_WGSIM_NAME = re.compile(r"^sim1_(\d+)_(\d+)_\d+:\d+:\d+_\d+:\d+:\d+_"
                         r"[0-9a-f]+/([12])$")
_COMP = bytes.maketrans(b"ACGTN", b"TGCAN")


def _fastq(path: str) -> list:
    """(name, bases) of each record of a FASTQ of 4-line records."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    return [(lines[i][1:].decode(), lines[i + 1])
            for i in range(0, len(lines) - 1, 4)]


def eval_placements(d: str) -> list:
    """Each wgsim read's placement by wgsim_eval alneval's own rule for
    its true place (no -c: a forward record's leftmost base at the
    name's first coordinate, a reverse one's rightmost at its second):
    read 1 forward, read 2 reverse (its bases reverse-complemented, as an
    aligner reports them); every ANC_MOVE_EVERY-th record moved ANC_MOVE
    bases away at MAPQ ANC_MOVE_MAPQ.  (qname, flag, pos, mapq, bases,
    moved), in the FASTQs' order, read 1 before read 2."""
    out = []
    for (n1, s1), (n2, s2) in zip(_fastq(os.path.join(d, "r1.fq")),
                                  _fastq(os.path.join(d, "r2.fq"))):
        m = _WGSIM_NAME.match(n1)
        lo, hi = int(m.group(1)), int(m.group(2))
        for name, seq, fl, pos in ((n1, s1, 0x41, lo),
                                   (n2, s2.translate(_COMP)[::-1], 0x91,
                                    hi - len(s2) + 1)):
            moved = len(out) % ANC_MOVE_EVERY == 0
            if moved:
                pos += ANC_MOVE if pos + ANC_MOVE + len(seq) < ANC_FRONT \
                    else -ANC_MOVE
            out.append((name[:-2], fl, pos, ANC_MOVE_MAPQ if moved else 60,
                        seq.decode(), moved))
    return out


def write_eval_inputs(d: str) -> None:
    """The ancillary process's step after wgsim: eval_placements as a SAM
    (for wgsim_eval) and in bowtie's format (for bowtie2sam)."""
    with open(os.path.join(d, "eval.sam"), "w") as sam, \
            open(os.path.join(d, "aln.bowtie"), "w") as bt:
        sam.write(f"@HD\tVN:1.6\tSO:unsorted\n@SQ\tSN:sim1\tLN:{ANC_FRONT}"
                  "\n")
        for name, fl, pos, mapq, seq, _ in eval_placements(d):
            sam.write(f"{name}\t{fl}\tsim1\t{pos}\t{mapq}\t{len(seq)}M\t*\t0"
                      f"\t0\t{seq}\t{'I' * len(seq)}\n")
            bt.write(f"{name}/{1 if fl & 0x40 else 2}\t"
                     f"{'-' if fl & 0x10 else '+'}\tsim1\t{pos - 1}\t{seq}\t"
                     f"{'I' * len(seq)}\t0\t\n")


def _inner_s_as_d(cigar: str) -> str:
    """A SAM CIGAR with each S op between two others read as D."""
    ops = re.findall(r"\d+[MIDNSHP=X]", cigar)
    return "".join(op[:-1] + "D" if 0 < i < len(ops) - 1 and op[-1] == "S"
                   else op for i, op in enumerate(ops))


def write_ace_sam(d: str) -> None:
    """The ancillary process's step after ace2sam -p -c: its SAM behind
    the header it wrote to stderr (the H lines), and the padded
    consensus it wrote there (the S lines) as a FASTA, for view and
    depad."""
    with open(os.path.join(d, "ace.err")) as f:
        err = f.read().splitlines()
    with open(os.path.join(d, "ace.sam")) as f:
        body = f.read()
    with open(os.path.join(d, "ace_full.sam"), "w") as f:
        f.write("".join(ln[2:] + "\n" for ln in err if ln.startswith("H "))
                + body)
    with open(os.path.join(d, "pad.fa"), "w") as f:
        f.write("".join(ln[2:] + "\n" for ln in err if ln.startswith("S ")))


def start_ancillary_tools(workdir: str, ref: np.ndarray, cram: str,
                          cram_bam: str):
    """wgsim, wgsim_eval, the converters, md5fa, md5sum-lite,
    seq_cache_populate, fasta-sanitize and ace2sam (module doc, phase
    15): starts the process that runs them and returns what waits for it
    and checks its outputs.  No kernel, no CUDA context."""
    from samtools_tpu_torch import sim
    t_phase = time.perf_counter()
    d = os.path.join(workdir, "ancillary")
    os.makedirs(d, exist_ok=True)
    p = lambda name: os.path.join(d, name)  # noqa: E731
    front = p("front.fa")
    write_fasta(front, ref[:ANC_FRONT])
    fa = os.path.join(workdir, "ref.fa")
    rng = np.random.default_rng(ANC_SEED)
    bad = [(n, "".join(rng.choice(list("ACGTN"), int(rng.integers(5, 90)))))
           for n in ANC_BAD_NAMES]
    with open(p("bad.fa"), "w") as f:
        f.write("".join(f">{n} d\n{s[:50]}\n{s[50:]}\n" for n, s in bad))
    asm = sim.ace_assembly(ANC_ACE_SEED)
    with open(p("in.ace"), "w") as f:
        f.write(asm.ace)
    cache = p("cache")
    runs = [
        ("wgsim", ["wgsim", "-S", str(ANC_SEED), "-N", str(ANC_PAIRS),
                   "-1", str(ANC_READ_LEN), "-2", str(ANC_READ_LEN), front,
                   p("r1.fq"), p("r2.fq")], p("mut.txt")),
        ("import -1 -2", ["import", "-1", p("r1.fq"), "-2", p("r2.fq"),
                          "-o", p("import.bam")], None),
        ("wgsim_eval alneval", ["wgsim_eval", "alneval", p("eval.sam")],
         p("alneval.txt")),
        ("wgsim_eval unique", ["wgsim_eval", "unique", p("eval.sam")],
         p("unique.sam")),
        ("bowtie2sam", ["bowtie2sam", p("aln.bowtie")], p("bowtie.sam")),
        ("md5fa", ["md5fa", fa], p("md5fa.txt")),
        ("md5sum-lite", ["md5sum-lite", fa], p("md5sum.txt")),
        ("seq_cache_populate -subdirs 0", [
            "seq_cache_populate", "-root", cache, "-subdirs", "0", fa],
         None, p("populate.err")),
        ("view (REF_CACHE)", ["view", cram], p("cram.sam")),
        ("view (BAM twin)", ["view", cram_bam], p("bam.sam")),
        ("fasta-sanitize", ["fasta-sanitize", p("bad.fa")], p("san.fa"),
         p("san.err")),
        ("ace2sam -p -c", ["ace2sam", "-p", "-c", p("in.ace")],
         p("ace.sam"), p("ace.err")),
        ("ace2sam", ["ace2sam", p("in.ace")], p("ace_u.sam"),
         p("ace_u.err")),
        ("view -c (ace2sam)", ["view", "-c", p("ace_full.sam")],
         p("ace_count.txt")),
        ("depad -T (ace2sam)", ["depad", "-s", "-T", p("pad.fa"),
                                p("ace_full.sam")], p("depad.sam")),
    ]
    proc = spawn_cli_child(d, "ancillary", runs, env={"REF_CACHE": cache},
                           before={"wgsim_eval alneval": [
                               "write_eval_inputs", [d]],
                               "view -c (ace2sam)": ["write_ace_sam", [d]]})

    def finish() -> dict:
        import hashlib

        from samtools_tpu_torch import kernels
        from samtools_tpu_torch.io.files import read_alignments
        before = dict(kernels.launches)
        res, _ = wait_cli_child(proc, d, "ancillary",
                                "the ancillary process", runs)
        n_reads = 2 * ANC_PAIRS
        # wgsim: both FASTQs whole, names that parse
        for k in (1, 2):
            recs = _fastq(p(f"r{k}.fq"))
            require(len(recs) == ANC_PAIRS and all(
                len(s) == ANC_READ_LEN and _WGSIM_NAME.match(n)
                and n.endswith(f"/{k}") for n, s in recs),
                    f"wgsim: r{k}.fq is not {ANC_PAIRS} records of "
                    f"{ANC_READ_LEN} bases with wgsim's names")
        imported = read_alignments(p("import.bam"), THREADS).batch.n
        require(imported == n_reads, f"import: {imported} reads")
        # alneval: the moved records, and only they, are wrong
        place = eval_placements(d)
        n_moved = sum(x[5] for x in place)
        with open(p("alneval.txt")) as f:
            rows = [re.match(r"^(\d+)x\s+(\d+) / (\d+)\s", ln).groups()
                    for ln in f]
        wrong = {int(q): int(w) for q, w, _ in rows}
        total = {int(q): int(t) for q, _, t in rows}
        require(sum(wrong.values()) == wrong.get(ANC_MOVE_MAPQ // 10)
                == n_moved and sum(total.values()) == n_reads,
                f"alneval: wrong {wrong} of {total}, {n_moved} moved")
        with open(p("unique.sam")) as f:
            uniq = sum(1 for ln in f if not ln.startswith("@"))
        require(uniq == ANC_PAIRS, f"unique: {uniq} records")
        with open(p("bowtie.sam")) as f:
            bt = [ln.split("\t") for ln in f.read().splitlines()]
        require(len(bt) == n_reads and all(
            (r[2], int(r[3]), r[9]) == ("sim1", x[2], x[4])
            for r, x in zip(bt, place)),
            "bowtie2sam: RNAME, POS or SEQ differ from the placements")
        # md5fa and md5sum-lite: the cram phase's @SQ M5, the file's MD5
        m5 = re.search(r"\tM5:([0-9a-f]{32})", read_alignments(
            cram_bam).header.text).group(1)
        with open(p("md5fa.txt")) as f:
            md5fa = [ln.split("  ") for ln in f.read().splitlines()]
        with open(fa, "rb") as f:
            whole = hashlib.md5(f.read()).hexdigest()
        with open(p("md5sum.txt")) as f:
            md5sum = f.read()
        require(md5fa[0][0] == m5 and md5fa[0][2] == "sim1"
                and md5fa[1][0] == md5fa[2][0] == m5,
                f"md5fa: {md5fa} against M5 {m5}")
        require(md5sum == f"{whole}  {fa}\n", f"md5sum-lite: {md5sum}")
        # the CRAM through the populated cache: the BAM twin's reads (the
        # eleven mandatory fields; bases N where no reference was found)
        require(os.path.getsize(os.path.join(cache, m5)) == ref.size,
                "seq_cache_populate: no flat cache entry")
        with open(p("cram.sam"), "rb") as f, open(p("bam.sam"), "rb") as g:
            cram_recs = [ln.split(b"\t")[:11] for ln in f.read().split(b"\n")]
            require(cram_recs == [ln.split(b"\t")[:11]
                                  for ln in g.read().split(b"\n")],
                    "view of the CRAM through REF_CACHE differs from its "
                    "BAM twin's reads")
        n_cram = len(cram_recs) - 1
        # fasta-sanitize: SAM's RNAME alphabet, sequences as they were
        with open(p("san.fa")) as f:
            san = f.read().split("\n")
        names = [ln[1:].split()[0] for ln in san if ln.startswith(">")]
        seqs = ["".join(san[i + 1:i + 3]) for i, ln in enumerate(san)
                if ln.startswith(">")]
        require(len(names) == len(bad) and all(map(_RNAME.match, names))
                and seqs == [s for _, s in bad],
                f"fasta-sanitize: names {names}")
        # ace2sam: a record a read and one a contig, CIGARs as long as
        # SEQ; view reads it, depad gives the unpadded records
        with open(p("ace.sam")) as f:
            ace = [ln.split("\t") for ln in f.read().splitlines()]
        with open(p("ace_count.txt")) as f:
            counted = int(f.read())
        require(len(ace) == counted == len(asm.reads) + len(asm.padded)
                and all(_query_len(r[5]) == len(r[9]) for r in ace),
                "ace2sam -p -c: records or CIGARs off")
        with open(p("depad.sam")) as f:
            dep = [ln.split("\t")[:6] for ln in f.read().splitlines()
                   if not ln.startswith("@") and ln.split("\t")[1] != "516"]
        with open(p("ace_u.sam")) as f:
            unp = [ln.split("\t")[:6] for ln in f.read().splitlines()]
        # ace2sam's unpadded CIGARs keep the JAX tool's fault: two D runs
        # around a squeezed P merge with their op bits added, 2 + 2 = S
        # (ROADMAP Queue 3); depad's D there is samtools' op
        faulty = [u for u, x in zip(unp, dep) if u != x]
        require(len(dep) == len(unp) and all(
            u[:5] == x[:5] and _inner_s_as_d(u[5]) == x[5]
            for u, x in zip(unp, dep) if u != x),
                "depad of ace2sam -p differs from ace2sam beyond its "
                "merged-D fault")
        require(kernels.launches == before,
                "the ancillary_tools phase launched a kernel")
        units = {"wgsim": ("reads", n_reads), "md5fa": ("bases", ref.size),
                 "md5sum-lite": ("bytes", os.path.getsize(fa)),
                 "seq_cache_populate -subdirs 0": ("bases", ref.size),
                 "view (REF_CACHE)": ("reads", n_cram),
                 "view (BAM twin)": ("reads", n_cram),
                 "fasta-sanitize": ("records", len(bad)),
                 "ace2sam -p -c": ("records", len(ace)),
                 "ace2sam": ("records", len(unp)),
                 "view -c (ace2sam)": ("records", len(ace)),
                 "depad -T (ace2sam)": ("records", len(ace))}
        for r, (label, *_) in zip(res["runs"], runs):
            unit, k = units.get(label, ("records", n_reads))
            emit({"phase": "ancillary_tools", "run": label, unit: k,
                  "wall_s": round(r["wall_s"], 3),
                  f"{unit}_per_s": round(k / r["wall_s"]), "launches": {},
                  "process": True})
        shutil.rmtree(d)
        emit({"phase": "ancillary_tools", "run": "all", "reads": n_reads,
              "moved": n_moved, "cram_reads": n_cram, "m5": m5,
              "ace_reads": len(asm.reads),
              "ace2sam_merged_d_fault_reads": len(faulty),
              "process_tune": res["tune"],
              "process_wall_s": round(res["process_wall_s"], 3),
              "wall_s": round(time.perf_counter() - t_phase, 3)})
        return res
    return finish


# the realign_tools phase: the pairs' templates in read group grpA (even
# template numbers) or grpB (odd ones), none on a template number
# REALIGN_NO_RG_AT modulo REALIGN_NO_RG_EVERY; the regions faidx fetches
# from clean's FASTA (their lengths up to REALIGN_REGION_MAX), and the
# reads fqidx fetches from the FASTQ fastq wrote
REALIGN_NO_RG_EVERY = 50
REALIGN_NO_RG_AT = 7
REALIGN_REGIONS = 1000
REALIGN_REGION_MAX = 5000
REALIGN_FQ_READS = 100
REALIGN_SEED = 29


def _fastq_records(path: str, fasta: bool = False) -> list:
    """(name, comment, sequence, quality) of each record of a FASTQ (a
    FASTA with ``fasta``: quality None) whose records take one line each,
    as fastq/fasta and fqidx write them."""
    with open(path, "rb") as f:
        lines = f.read().split(b"\n")
    step = 2 if fasta else 4
    require(lines[-1] == b"" and (len(lines) - 1) % step == 0,
            f"{path}: not whole records")
    head = lines[0:-1:step]
    require(all(h[:1] == (b">" if fasta else b"@") for h in head)
            and (fasta or all(x == b"+" for x in lines[2:-1:4])),
            f"{path}: a malformed record")
    names = [h[1:].split(b"\t", 1) for h in head]
    return [(nm[0], nm[1] if len(nm) > 1 else b"", sq,
             None if fasta else ql)
            for nm, sq, ql in zip(names, lines[1:-1:step],
                                  lines[3:-1:4] if not fasta
                                  else [None] * len(head))]


def _read_texts(b) -> dict:
    """(qname, 1 for READ1 or 2 for READ2) -> (sequence, quality) of each
    record of ``b`` as fastq prints it: a reverse read reverse
    complemented (its qualities reversed), qualities + 33."""
    from samtools_tpu_torch.core.flags import SEQ_NT16_STR
    comp = np.array([int(f"{c:04b}"[::-1], 2) for c in range(16)], np.uint8)
    chars = np.frombuffer(SEQ_NT16_STR.encode(), np.uint8)
    lens = np.diff(b.seq_off)
    read = np.repeat(np.arange(b.n), lens)
    rev = (b.flag & 0x10 != 0)[read]
    within = np.arange(b.seq.size) - b.seq_off[read]
    src = np.where(rev, b.seq_off[read] + lens[read] - 1 - within,
                   np.arange(b.seq.size))
    seq = chars[np.where(rev, comp[b.seq[src]], b.seq[src])].tobytes()
    qual = (b.qual[src] + 33).astype(np.uint8).tobytes()
    off = b.seq_off.tolist()
    part = np.where(b.flag & 0x40, 1, 2).tolist()
    return {(b.qname_str(i).encode(), part[i]):
            (seq[off[i]:off[i + 1]], qual[off[i]:off[i + 1]])
            for i in range(b.n)}


def _unaligned_rows(b) -> list:
    """(qname, flag, sequence, qualities, aux) of each record of ``b``,
    sorted."""
    return sorted((b.qname_str(i), int(b.flag[i]), b.seq_of(i).tobytes(),
                   b.qual_of(i).tobytes(), b.aux_of(i).tobytes())
                  for i in range(b.n))


def _faidx_records(path: str) -> list:
    """(header, sequence) of each record faidx printed into ``path``."""
    with open(path, "rb") as f:
        text = f.read()
    require(text[:1] == b">", f"{path}: not FASTA")
    out = []
    for rec in text[1:].split(b"\n>"):
        head, _, body = rec.partition(b"\n")
        out.append((head, body.replace(b"\n", b"")))
    return out


def phase_realign_tools(workdir: str, pairs: str, ref: np.ndarray,
                        beside=None) -> None:
    """fastq, fasta, import, reset, split, faidx, fqidx and dict (module
    doc, phase 19): two processes at once, their outputs checked here;
    no kernel and no CUDA context.  ``beside(rg, header, reads)``, when
    given, starts another phase's processes on the read-group BAM once
    this phase's are running, and returns what waits for and checks
    them, called before this phase's files go."""
    import hashlib

    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.io.bam import write_bam
    from samtools_tpu_torch.io.files import read_alignments
    from samtools_tpu_torch.io.header import SamHeader
    t_phase = time.perf_counter()
    before = dict(kernels.launches)
    d = os.path.join(workdir, "realign_tools")
    os.makedirs(d, exist_ok=True)
    p = lambda name: os.path.join(d, name)  # noqa: E731
    threads = str(THREADS)
    rng = np.random.default_rng(REALIGN_SEED)

    # the pairs in their read groups, written by the port's writer
    got = read_alignments(pairs, THREADS)
    b = got.batch
    n = b.n
    width = int(b.qname_off[1] - b.qname_off[0])
    digits = b.qname.reshape(n, width)[:, 1:].astype(np.int64) - 48
    tmpl = digits @ (10 ** np.arange(width - 2, -1, -1, dtype=np.int64))
    group = np.where(tmpl % REALIGN_NO_RG_EVERY == REALIGN_NO_RG_AT, 2,
                     tmpl % 2)
    tags = (b"RGZgrpA\0", b"RGZgrpB\0", b"")
    b.aux = np.frombuffer(b"".join(tags[g] for g in group.tolist()),
                          np.uint8)
    b.aux_off = np.concatenate([[0], np.cumsum(
        np.array([len(t) for t in tags])[group])]).astype(np.int64)
    header = SamHeader.from_text(got.header.text + "@RG\tID:grpA\tSM:s1\n"
                                 "@RG\tID:grpB\tSM:s2\n")
    rg = p("rg.bam")
    write_bam(rg, header, b, threads=THREADS)
    # clean's FASTA without its .fai (faidx writes it), the regions and
    # the reads fqidx fetches
    fa = p("clean.fa")
    with open(os.path.join(workdir, "ref.fa"), "rb") as f, \
            open(fa, "wb") as g:
        g.write(f.read())
    beg = rng.integers(0, ref.size - REALIGN_REGION_MAX, REALIGN_REGIONS)
    end = beg + rng.integers(1, REALIGN_REGION_MAX + 1, REALIGN_REGIONS)
    regions = [f"sim1:{s + 1}-{e}" for s, e in zip(beg.tolist(),
                                                   end.tolist())]
    with open(p("regions.txt"), "w") as f:
        f.write("".join(r + "\n" for r in regions))
    names = sorted({b.qname_str(int(i)) for i in rng.choice(
        n, REALIGN_FQ_READS * 2, replace=False)})[:REALIGN_FQ_READS]
    with open(p("reads.txt"), "w") as f:
        f.write("".join(x + "/1\n" for x in names))

    # the pairs' round trip, and clean's FASTA with the read groups' split
    pair_runs = [
        ("collate -u", ["collate", "-@", threads, "-u", "-o", p("g.bam"),
                        rg], None),
        ("fastq", ["fastq", "-@", threads, "-1", p("r1.fq"), "-2",
                   p("r2.fq"), "-0", p("r0.fq"), "-s", p("s.fq"), "-N",
                   "-T", "RG", p("g.bam")], None),
        ("fasta", ["fasta", "-@", threads, "-N", "-o", p("reads.fa"), "-0",
                   p("r0.fa"), p("g.bam")], None),
        ("import", ["import", "-@", threads, "-1", p("r1.fq"), "-2",
                    p("r2.fq"), "-T", "*", "-o", p("imp.bam")], None),
        ("fqidx", ["fqidx", p("r1.fq")], None),
        ("fqidx -r", ["fqidx", "-r", p("reads.txt"), p("r1.fq")],
         p("fq_fetched.fq"))]
    ref_runs = [
        ("faidx", ["faidx", fa], None),
        ("faidx -r", ["faidx", "-r", p("regions.txt"), fa], p("fetched.fa")),
        ("faidx -i -r", ["faidx", "-i", "-r", p("regions.txt"), fa],
         p("fetched_rc.fa")),
        ("dict", ["dict", "-o", p("clean.dict"), fa], None),
        ("reset", ["reset", "-@", threads, "-o", p("rs.bam"), rg], None),
        ("split", ["split", "-@", threads, "-f", p("%*_%!.bam"), "-u",
                   p("no_rg.bam"), rg], None)]
    procs = {"pairs": spawn_cli_child(d, "pairs", pair_runs),
             "ref": spawn_cli_child(d, "ref", ref_runs)}
    finish_beside = beside(rg, header, b) if beside is not None else None
    # what the checks hold the outputs to, meanwhile
    want = _read_texts(b)
    want_group = {b.qname_str(i).encode(): group[i] for i in range(n)}
    del got
    region_bases = int((end - beg).sum())
    outputs = {
        "collate -u": [p("g.bam")],
        "fastq": [p(x) for x in ("r1.fq", "r2.fq", "r0.fq", "s.fq")],
        "fasta": [p("reads.fa"), p("r0.fa")], "import": [p("imp.bam")],
        "fqidx": [p("r1.fq.fai")], "fqidx -r": [p("fq_fetched.fq")],
        "faidx": [fa + ".fai"], "faidx -r": [p("fetched.fa")],
        "faidx -i -r": [p("fetched_rc.fa")], "dict": [p("clean.dict")],
        "reset": [p("rs.bam")],
        "split": [p(f"rg_{x}.bam") for x in ("grpA", "grpB")]
        + [p("no_rg.bam")]}
    counts = {"fqidx": n // 2, "fqidx -r": REALIGN_FQ_READS}
    bases = {"faidx": ref.size, "faidx -r": region_bases,
             "faidx -i -r": region_bases, "dict": ref.size}
    walls = {}
    for name, runs in (("pairs", pair_runs), ("ref", ref_runs)):
        res, _ = wait_cli_child(procs[name], d, name,
                                f"the {name} process", runs)
        walls[name] = res["process_wall_s"]
        for r, (label, _, _) in zip(res["runs"], runs):
            line = {"phase": "realign_tools", "run": label,
                    "wall_s": round(r["wall_s"], 3)}
            if label in bases:
                line.update(bases=bases[label],
                            bases_per_s=round(bases[label] / r["wall_s"]))
            else:
                k = counts.get(label, n)
                line.update(reads=k, reads_per_s=round(k / r["wall_s"]))
            emit({**line, "output_bytes": sum(os.path.getsize(o)
                                              for o in outputs[label]),
                  "launches": {}, "process": True})

    # fastq: every primary once; sequence and qualities those of its
    # columns, read orientation; R1 and R2 pair up; its read group
    r1, r2 = _fastq_records(p("r1.fq")), _fastq_records(p("r2.fq"))
    rest = _fastq_records(p("r0.fq")) + _fastq_records(p("s.fq"))
    primary = int(np.count_nonzero(b.flag & 0x900 == 0))
    require(len(r1) + len(r2) + len(rest) == primary == n and not rest,
            f"fastq: {len(r1)} + {len(r2)} + {len(rest)} records of "
            f"{primary} primaries")
    require([x[0][:-2] for x in r1] == [x[0][:-2] for x in r2]
            and all(x[0].endswith(b"/1") for x in r1)
            and all(x[0].endswith(b"/2") for x in r2),
            "fastq: the READ1 and READ2 names do not pair up")
    rg_comment = (b"RG:Z:grpA", b"RG:Z:grpB", b"")
    for part, recs in ((1, r1), (2, r2)):
        for name, comment, seq, qual in recs:
            key = name[:-2]
            require(want.pop((key, part)) == (seq, qual)
                    and comment == rg_comment[want_group[key]],
                    f"fastq: {name!r} differs from its BAM record")
    require(not want, f"fastq: {len(want)} reads never came out")
    emit({"phase": "realign_tools", "run": "fastq checks", "reads": n,
          "pairs": len(r1), "equal_to_columns": True})
    # fasta: the same sequences, interleaved
    fa_recs = _fastq_records(p("reads.fa"), fasta=True)
    require([(x[0], x[2]) for x in fa_recs]
            == [(a[0], a[2]) for pair in zip(r1, r2) for a in pair]
            and _fastq_records(p("r0.fa"), fasta=True) == [],
            "fasta: not fastq's sequences, READ1 then READ2")
    # import of fastq's files against reset of the BAM: the same
    # unaligned records
    imp, rs = read_alignments(p("imp.bam")).batch, \
        read_alignments(p("rs.bam")).batch
    require(imp.n == rs.n == n and (imp.flag & 0x4).all()
            and (rs.tid == -1).all() and (imp.tid == -1).all(),
            f"import / reset: {imp.n} and {rs.n} unaligned reads of {n}")
    require(_unaligned_rows(imp) == _unaligned_rows(rs),
            "import of fastq's files and reset of the BAM differ")
    del imp, rs
    # split: the outputs' reads add up to the input's; each read group's
    # header keeps only its @RG line
    split_n = 0
    for k, gname in enumerate(("grpA", "grpB", None)):
        out = read_alignments(p(f"rg_{gname}.bam" if gname
                                else "no_rg.bam"))
        rgs = [ln for ln in out.header.lines() if ln.startswith("@RG")]
        flat = out.batch.aux.tobytes()
        if gname:
            require(rgs == [f"@RG\tID:{gname}\tSM:s{k + 1}"]
                    and flat.count(b"RGZ") == out.batch.n
                    == flat.count(f"RGZ{gname}\0".encode()),
                    f"split: {gname}'s output holds other read groups")
        else:
            require(len(rgs) == 2 and b"RGZ" not in flat,
                    "split: a read with a read group left unaccounted")
        require(out.batch.n == int(np.count_nonzero(group == k)),
                f"split: {out.batch.n} reads in {gname}")
        split_n += out.batch.n
    require(split_n == n, f"split: {split_n} reads of {n}")
    # fqidx: the index beside the FASTQ, the reads fetched equal to their
    # records
    with open(p("r1.fq.fai")) as f:
        require(sum(1 for _ in f) == len(r1), "fqidx: not a line a read")
    by_name = {x[0]: (x[2], x[3]) for x in r1}
    fetched = _fastq_records(p("fq_fetched.fq"))
    require([x[0] for x in fetched] == [x.encode() + b"/1" for x in names]
            and all(by_name[x[0]] == (x[2], x[3]) for x in fetched),
            "fqidx: a fetched read differs from its record")
    # faidx: the .fai written; each region the reference's slice, -i its
    # reverse complement
    with open(fa + ".fai") as f:
        require(f.read() == f"sim1\t{ref.size}\t6\t60\t61\n",
                "faidx: not clean's .fai")
    comp = np.arange(256, dtype=np.uint8)
    comp[np.frombuffer(b"ACGT", np.uint8)] = np.frombuffer(b"TGCA",
                                                           np.uint8)
    for path, rc in ((p("fetched.fa"), False), (p("fetched_rc.fa"), True)):
        recs = _faidx_records(path)
        require(len(recs) == REALIGN_REGIONS, f"faidx: {len(recs)} records")
        for (head, seq), reg, s, e in zip(recs, regions, beg.tolist(),
                                          end.tolist()):
            piece = ref[s:e]
            require(head == (reg + ("/rc" if rc else "")).encode()
                    and seq == (comp[piece][::-1] if rc
                                else piece).tobytes(),
                    f"faidx{' -i' if rc else ''}: {reg} differs from the "
                    "reference")
    # dict: LN and M5 of the upper-cased sequence
    with open(p("clean.dict")) as f:
        sq = [ln.rstrip("\n").split("\t") for ln in f
              if ln.startswith("@SQ")]
    md5 = hashlib.md5(bytes(ref).upper()).hexdigest()
    require(len(sq) == 1 and sq[0][1:4] == ["SN:sim1", f"LN:{ref.size}",
                                            f"M5:{md5}"],
            f"dict: {sq}")
    require(kernels.launches == before,
            "the realign_tools phase launched a kernel")
    t_realign = time.perf_counter() - t_phase
    if finish_beside is not None:
        finish_beside()
    for x in os.listdir(d):
        os.remove(os.path.join(d, x))
    os.rmdir(d)
    emit({"phase": "realign_tools", "run": "all", "reads": n,
          "regions": REALIGN_REGIONS, "region_bases": region_bases,
          "pairs_process_wall_s": round(walls["pairs"], 3),
          "ref_process_wall_s": round(walls["ref"], 3),
          "wall_s": round(t_realign, 3),
          "with_beside_wall_s": round(time.perf_counter() - t_phase, 3)})


# the header_tools phase: checksum's cut of the read-group BAM (the first
# reads, two halves of it merged with -m); calmd -b and reference on
# clean's first reads; depad on messy's reads inside the start of the
# contig, padded by sim.pad_reads
HEADER_CHECKSUM_READS = 40_000
HEADER_MD_READS = 50_000
HEADER_PAD_END = 60_000
HEADER_PAD_SEED = 31


def _first_reads(path: str, n: int = 0, end: int | None = None):
    """The header and the first ``n`` reads of a BAM, or with ``end`` its
    reads that lie in [0, end), streamed."""
    from samtools_tpu_torch.core.batch import ReadBatch
    from samtools_tpu_torch.io.stream import BamStream
    parts, got = [], 0
    with BamStream(path, THREADS) as st:
        header = st.header
        for b in st.batches():
            if end is not None:
                keep = np.flatnonzero((b.pos + b.ref_span()) <= end)
                parts.append(b.take(keep))
                if b.n and int(b.pos[-1]) >= end:
                    break
                continue
            parts.append(b.take(np.arange(min(b.n, n - got))))
            got += parts[-1].n
            if got >= n:
                break
    return header, ReadBatch.concat(parts)


def _report_rows(path: str) -> list:
    """A checksum report's lines less the one that names its file."""
    with open(path) as f:
        return [ln for ln in f if not ln.startswith("# Checksum")]


def _cram_tail(path: str) -> bytes:
    """A CRAM's bytes from its first container after the header's."""
    from samtools_tpu_torch.io.cram import (parse_container,
                                            parse_file_definition)
    with open(path, "rb") as f:
        data = f.read()
    major, _minor, pos = parse_file_definition(data)
    cont, i = parse_container(data, pos, major)
    return data[i + cont.length:]


def start_header_tools(workdir: str, rg: str, rg_header, rg_reads,
                       ref: np.ndarray, cram: str, cram_bam: str,
                       clean: str, messy: str):
    """reheader, samples, checksum, depad, reference and cram-size (module
    doc, phase 20): writes the inputs, starts the two processes and
    returns what waits for them and checks their outputs; no kernel and
    no CUDA context."""
    import shutil

    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.io import bgzf
    from samtools_tpu_torch.io.bam import write_bam
    from samtools_tpu_torch.io.files import read_alignments
    from samtools_tpu_torch.io.header import SamHeader
    from samtools_tpu_torch.sim import pad_reads
    t_phase = time.perf_counter()
    before = dict(kernels.launches)
    d = os.path.join(workdir, "header_tools")
    os.makedirs(d, exist_ok=True)
    p = lambda name: os.path.join(d, name)  # noqa: E731
    fa = os.path.join(workdir, "ref.fa")

    # checksum's cut and its halves; the new header; the CRAM's copy
    half = HEADER_CHECKSUM_READS // 2
    for name, lo, hi in (("cut", 0, 2 * half), ("half_a", 0, half),
                         ("half_b", half, 2 * half)):
        write_bam(p(name + ".bam"), rg_header,
                  rg_reads.take(np.arange(lo, hi)), threads=THREADS)
    with open(p("hdr.sam"), "w") as f:
        f.write(rg_header.text + "@CO\theader_tools\n")
    shutil.copy(cram, p("copy.cram"))
    twin = read_alignments(cram_bam, THREADS)
    # clean's first reads, for calmd -b and reference
    clean_header, md_in = _first_reads(clean, HEADER_MD_READS)
    write_bam(p("clean_first.bam"), clean_header, md_in, threads=THREADS)
    md_end = int((md_in.pos + md_in.ref_span()).max())
    del md_in
    # messy's reads inside the contig's first HEADER_PAD_END bases, padded
    _, unpadded = _first_reads(messy, end=HEADER_PAD_END)
    gone = unpadded.mpos >= HEADER_PAD_END  # mates past the cut: none
    unpadded.mtid[gone] = -1
    unpadded.mpos[gone] = -1
    t0 = time.perf_counter()
    (padded,), pb = pad_reads([ref[:HEADER_PAD_END]], unpadded,
                              HEADER_PAD_SEED)
    t_pad = time.perf_counter() - t0
    write_bam(p("padded.bam"), SamHeader.from_text(
        f"@HD\tVN:1.6\tSO:coordinate\n@SQ\tSN:sim1\tLN:{padded.size}\n"),
        pb, threads=THREADS)
    write_fasta(p("padded.fa"), padded)

    sed = "sed -e '/^@RG\tID:grpB/d'"
    add_co = "cat; printf '@CO\\tin place\\n'"
    sum_runs = [
        ("checksum", ["checksum", "-o", p("cut.chk"), p("cut.bam")], None),
        ("checksum half a", ["checksum", "-o", p("a.chk"), p("half_a.bam")],
         None),
        ("checksum half b", ["checksum", "-o", p("b.chk"), p("half_b.bam")],
         None),
        ("checksum -m", ["checksum", "-m", "-o", p("merged.chk"),
                         p("a.chk"), p("b.chk")], None),
        ("checksum -B", ["checksum", "-B", "-o", p("bb.chk"), p("cut.bam")],
         None)]
    hdr_runs = [
        ("samples -i -f", ["samples", "-i", "-f", fa, rg], p("samples.tsv")),
        ("reheader", ["reheader", p("hdr.sam"), rg], p("rh.bam")),
        ("reheader -P -c", ["reheader", "-P", "-c", sed, rg], p("rh_c.bam")),
        ("reheader -i (CRAM)", ["reheader", "-i", "-P", "-c", add_co,
                                p("copy.cram")], None),
        ("view (CRAM copy)", ["view", "-@", str(THREADS), "--no-PG", "-b",
                              "-o", p("copy.bam"), p("copy.cram")], None),
        ("cram-size", ["cram-size", "-o", p("size.txt"), cram], None),
        ("cram-size -v -e", ["cram-size", "-v", "-e", "-o",
                             p("size_ve.txt"), cram], None),
        ("calmd -b", ["calmd", "-b", p("clean_first.bam"), fa],
         p("md.bam")),
        ("reference", ["reference", "-o", p("ref_out.fa"), p("md.bam")],
         None),
        ("depad -T", ["depad", "-T", p("padded.fa"), "-o", p("depad.bam"),
                      p("padded.bam")], None),
        ("checksum -a", ["checksum", "-a", "-o", p("all.chk"),
                         p("cut.bam")], None)]
    procs = {"checksum": spawn_cli_child(d, "checksum", sum_runs),
             "header": spawn_cli_child(d, "header", hdr_runs, env={
                 "REF_CACHE": os.path.join(workdir, "ref_cache")})}
    t_prep = time.perf_counter() - t_phase

    def finish() -> None:
        n_rg = rg_reads.n
        # the reads each run reads (none: it reads headers or blocks)
        counts = {"samples -i -f": None, "reheader": n_rg,
                  "reheader -P -c": n_rg, "reheader -i (CRAM)": None,
                  "view (CRAM copy)": twin.batch.n, "cram-size": None,
                  "cram-size -v -e": None, "calmd -b": HEADER_MD_READS,
                  "reference": HEADER_MD_READS, "depad -T": unpadded.n,
                  "checksum half a": half, "checksum half b": half,
                  "checksum -m": None}
        walls = {}
        for name, runs in (("checksum", sum_runs), ("header", hdr_runs)):
            res, _ = wait_cli_child(procs[name], d, name,
                                    f"the {name} process", runs)
            walls[name] = res["process_wall_s"]
            for r, (label, _, _) in zip(res["runs"], runs):
                k = counts.get(label, HEADER_CHECKSUM_READS)
                line = {"phase": "header_tools", "run": label,
                        "wall_s": round(r["wall_s"], 3)}
                if k:
                    line.update(reads=k, reads_per_s=round(k / r["wall_s"]))
                emit({**line, "launches": {}, "process": name})

        # samples: one row a read group, no index, clean's FASTA matches
        with open(p("samples.tsv")) as f:
            require(f.read() == f"s1\t{rg}\tN\t{fa}\ns2\t{rg}\tN\t{fa}\n",
                    "samples: not the rows s1 and s2")
        # reheader: the new header, then the input's blocks copied raw
        with open(rg, "rb") as f:
            data = f.read()
        coffs, _ = bgzf.scan_blocks(data)
        tail = data[int(coffs[1]):]
        for out, what in ((p("rh.bam"), "reheader"),
                          (p("rh_c.bam"), "reheader -P -c")):
            with open(out, "rb") as f:
                require(f.read().endswith(tail),
                        f"{what}: the record blocks are not the input's")
        rh = read_alignments(p("rh.bam"), THREADS)
        require(rh.header.text.startswith(rg_header.text
                                          + "@CO\theader_tools\n@PG\t")
                and _same_records(rh.batch, rg_reads),
                "reheader: not the new header over the same records")
        del rh
        rhc = read_alignments(p("rh_c.bam"), THREADS)
        require(rhc.header.text == rg_header.text.replace(
            "@RG\tID:grpB\tSM:s2\n", "") and _same_records(rhc.batch,
                                                           rg_reads),
                "reheader -P -c: not sed's header over the same records")
        del rhc, data, tail
        # reheader -i: the CRAM's records untouched, its header the new
        # one; the copy decodes to the reads of the BAM twin
        require(os.path.getsize(p("copy.cram")) == os.path.getsize(cram)
                and _cram_tail(p("copy.cram")) == _cram_tail(cram),
                "reheader -i: the CRAM's containers changed")
        copy = read_alignments(p("copy.bam"), THREADS)
        require(copy.header.text == twin.header.text + "@CO\tin place\n"
                and _same_records(copy.batch, twin.batch),
                "reheader -i: the CRAM's copy decodes to other reads")
        del copy
        # checksum: the halves merged are the cut's report
        whole, merged = _report_rows(p("cut.chk")), \
            _report_rows(p("merged.chk"))
        require(len(whole) > 6 and merged == whole,
                "checksum -m of the halves is not the cut's report")
        for path in (p("all.chk"), p("bb.chk")):
            rows = [ln.split() for ln in _report_rows(path)
                    if ln.startswith("all")]
            require(rows and int(rows[0][2]) == HEADER_CHECKSUM_READS,
                    f"checksum: {path} does not count every read")
        # reference: every base it prints is clean's, and it covers the
        # reads' span
        with open(p("ref_out.fa"), "rb") as f:
            lines = f.read().split(b"\n")
        require(lines[0] == b">sim1", "reference: not one contig")
        got = np.frombuffer(b"".join(lines[1:]), np.uint8)
        known = got != ord("N")
        require(got.size == ref.size
                and np.array_equal(got[known], ref[known])
                and known[:md_end].mean() > 0.95
                and not known[md_end + READ_LEN:].any(),
                "reference: a base differs from clean's reference")
        # depad: each read back at its unpadded position and span
        dp = read_alignments(p("depad.bam"), THREADS)
        require(dp.header.ref_lens == [HEADER_PAD_END]
                and np.array_equal(dp.batch.pos, unpadded.pos)
                and np.array_equal(dp.batch.ref_span(), unpadded.ref_span())
                and np.array_equal(dp.batch.seq, unpadded.seq),
                "depad: reads not back at their unpadded places")
        del dp
        # cram-size: within the file; -v has a row for every content ID
        def blocks(path):
            with open(path) as f:
                rows = [ln.split() for ln in f if ln.startswith("BLOCK")]
            return {r[1] for r in rows}, sum(int(r[3]) for r in rows)
        ids, comp = blocks(p("size.txt"))
        vids, vcomp = blocks(p("size_ve.txt"))
        with open(p("size_ve.txt")) as f:
            encodings = f.read().count("Container encodings")
        require(ids == vids and comp == vcomp
                and 0 < comp <= os.path.getsize(cram) and encodings > 0,
                "cram-size: sizes out of the file, or -v's IDs differ")
        require(kernels.launches == before,
                "the header_tools phase launched a kernel")
        for x in os.listdir(d):
            os.remove(os.path.join(d, x))
        os.rmdir(d)
        emit({"phase": "header_tools", "run": "all", "rg_reads": n_rg,
              "checksum_reads": HEADER_CHECKSUM_READS,
              "md_reads": HEADER_MD_READS, "padded_reads": unpadded.n,
              "padded_len": int(padded.size), "pad_reads_s": round(t_pad, 3),
              "cram_reads": twin.batch.n,
              "cram_bytes": os.path.getsize(cram),
              "prep_s": round(t_prep, 3),
              "checksum_process_wall_s": round(walls["checksum"], 3),
              "header_process_wall_s": round(walls["header"], 3),
              "wall_s": round(time.perf_counter() - t_phase, 3)})
    return finish


# the sharded cell: a 2.5 Mi contig (three spans under SAMTPU_SHARDS=3)
# at 10x of 100 bp reads, indexed
SHARD_LEN = 5 << 19
SHARD_COVERAGE = 10.0
SHARD_SEED = 41
SHARD_SPANS = 3
# span worker runs: (label, argv); {fa}, {bam} from the cell
SHARD_RUNS = (("mpileup -f", ["mpileup", "-f", "{fa}", "{bam}"]),
              ("consensus", ["consensus", "{bam}"]))


def _k14_case(dev, refpos, lane, valid, qual, window: int,
              tile: int = 512, full: bool = True) -> dict:
    """K14's two entries on one set of items, on the card: the scatter
    (counts and qual sums) and the tiled form over the items bucketed by
    ``bucket_bases``, each equal to its plain version and to
    ``index_put_(accumulate=True)`` on the same cells exactly, with the
    scatter's chunks by path (private, global, empty), device ms (a CUDA
    graph of the bare C entry) and the bound from bytes (each item's
    valid flag read once, the other fields of the valid items once, the
    output written once: ``item_bytes``); ``full``: also ms, b2b ms, the
    plain version's and ``index_put_``'s time on the same tensors (the
    valid items' cells found before the timing)."""
    import torch
    from samtools_tpu_torch import kernels
    from samtools_tpu_torch.ops import pileup_device as pd
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for a in (refpos, lane, valid, qual)]
    rp, ln, ok, q = t
    n = rp.numel()
    before = kernels.launches["pileup_scatter"]
    counts = pd.pileup_counts(rp, ln, ok, window)
    sums = pd.pileup_qual_sums(rp, ln, q, ok, window)
    require(kernels.launches["pileup_scatter"] == before + 2,
            "K14's scatter did not launch once a call")
    err = max(int((counts - pd.pileup_scatter_plain(rp, ln, ok, window))
                  .abs().max()),
              int((sums - pd.pileup_scatter_plain(rp, ln, ok, window, q))
                  .abs().max()))
    require(err == 0, f"K14's scatter differs from its plain version ({err})")
    ln_j = torch.where(ln < 0, ln + 32, ln)
    keep = ok & (rp >= 0) & (rp < window) & (ln_j >= 0) & (ln_j < 32)
    require(int(counts.sum()) == int(keep.sum()), "K14 lost items")
    cells = (rp[keep].long(), ln_j[keep].long())
    ones = torch.ones(cells[0].numel(), dtype=torch.int32, device=dev)
    lib = torch.zeros_like(counts)
    lib.index_put_(cells, ones, accumulate=True)
    require(torch.equal(lib, counts), "index_put_ differs from K14")
    lib_q = torch.zeros_like(sums)
    lib_q.index_put_(cells, q[keep], accumulate=True)
    require(torch.equal(lib_q, sums), "index_put_ differs from K14's sums")
    out_bytes = window * 32 * 4
    chunk = pd.scatter_chunk(n, kernels.sm_count(dev))
    nv = int(ok.sum())
    row = dict(
        max_abs_err=err,
        device_ms=graph_ms(pk().scatter_bare(rp, ln, ok, window)),
        qual_sums_device_ms=graph_ms(pk().scatter_bare(rp, ln, ok, window,
                                                       q)),
        detail={"items": n, "valid": nv, "window": window,
                "paths": pk().scatter_paths(rp, ln, ok, window, chunk)},
        **dict(zip(("bound_ms", "bound_by"),
                   bound(pk().item_bytes(n, nv, 9) + out_bytes, nv))),
        qual_sums_bound_ms=bound(pk().item_bytes(n, nv, 13) + out_bytes,
                                 0)[0])
    if full:
        row.update(
            ms=cuda_ms(lambda: pd.pileup_counts(rp, ln, ok, window)),
            b2b_ms=cuda_ms(lambda: pd.pileup_counts(rp, ln, ok, window),
                           per=10),
            plain_ms=cuda_ms(lambda: pd.pileup_scatter_plain(rp, ln, ok,
                                                             window),
                             reps=3),
            library_ms=cuda_ms(lambda: lib.index_put_(cells, ones,
                                                      accumulate=True)),
            qual_sums_ms=cuda_ms(lambda: pd.pileup_qual_sums(rp, ln, q, ok,
                                                             window)))
    # the tiled entry over the valid in-window items bucketed by tile
    inwin = (refpos >= 0) & (refpos < window) & valid
    tt = [torch.from_numpy(a).to(dev) for a in pd.bucket_bases(
        refpos[inwin], lane[inwin], window, tile)]
    posrel = tt[0]
    n_tiles, B = posrel.shape
    tnv = int(tt[2].sum())
    before = kernels.launches["pileup_tiled"]
    tiled = pd.pileup_counts_tiled(*tt, tile, n_tiles)
    require(kernels.launches["pileup_tiled"] == before + 1,
            "K14's tiled entry did not launch once")
    terr = int((tiled - pd.pileup_tiled_plain(*tt, tile, n_tiles))
               .abs().max())
    require(terr == 0, f"K14's tiled entry differs from its plain version "
            f"({terr})")
    # the in-window items with lanes in [0, 32) count alike in both
    # entries
    lanes_in = (lane[inwin] >= 0) & (lane[inwin] < 32)
    if lanes_in.all():
        require(torch.equal(tiled[:window], counts),
                "K14's tiled entry differs from its scatter entry")
    # the library call on the bucketed items' cells (row t * tile + posrel)
    tok = tt[2] & (posrel >= 0) & (posrel < tile) & (tt[1] >= 0) \
        & (tt[1] < 32)
    tcells = ((torch.arange(n_tiles, device=dev)[:, None] * tile
               + posrel)[tok].long(), tt[1][tok].long())
    tones = torch.ones(tcells[0].numel(), dtype=torch.int32, device=dev)
    tlibout = torch.zeros_like(tiled)
    tlibout.index_put_(tcells, tones, accumulate=True)
    require(torch.equal(tlibout, tiled), "index_put_ differs from K14 tiled")
    row["tiled"] = dict(
        max_abs_err=terr,
        device_ms=graph_ms(pk().tiled_bare(tt, tile)),
        detail={"tiles": n_tiles, "B": B, "tile": tile, "valid": tnv},
        **dict(zip(("bound_ms", "bound_by"),
                   bound(pk().item_bytes(posrel.numel(), tnv, 9)
                         + n_tiles * tile * 32 * 4, tnv))))
    if full:
        row["tiled"].update(
            ms=cuda_ms(lambda: pd.pileup_counts_tiled(*tt, tile, n_tiles)),
            b2b_ms=cuda_ms(lambda: pd.pileup_counts_tiled(*tt, tile,
                                                          n_tiles), per=10),
            plain_ms=cuda_ms(lambda: pd.pileup_tiled_plain(*tt, tile,
                                                           n_tiles),
                             reps=3),
            library_ms=cuda_ms(lambda: tlibout.index_put_(
                tcells, tones, accumulate=True)))
    return row


def k14_hard_shapes(c_rp, c_ln, c_ok, c_q) -> dict:
    """K14's hard shapes beside the main ones: 2 Mi position-sorted items
    over a 1 Mi-row window (two a row: every chunk spans about 1,000 rows,
    over the private budget, and adds through global atomics), 100,000
    items on one cell, and clean's 1 Mbp items back to front."""
    rng = np.random.default_rng(SHARD_SEED + 1)
    n = 1 << 21
    shapes = {"sorted_over_budget": (
        np.sort(rng.integers(0, 1 << 20, n)).astype(np.int32),
        rng.integers(0, 32, n).astype(np.int32), np.ones(n, bool),
        rng.integers(2, 41, n).astype(np.int32), 1 << 20)}
    m = 100_000
    shapes["one_cell"] = (np.full(m, 5, np.int32), np.full(m, 3, np.int32),
                          np.ones(m, bool), np.full(m, 37, np.int32), 16)
    shapes["reversed"] = (c_rp[::-1].copy(), c_ln[::-1].copy(),
                          c_ok[::-1].copy(), c_q[::-1].copy(), 1 << 20)
    return shapes


def write_shard_inputs(workdir: str) -> dict:
    """The sharded cell as an indexed BAM and its FASTA under
    ``workdir``."""
    from samtools_tpu_torch.io.bam import write_bam
    from samtools_tpu_torch.sim import (make_header, simulate_batch,
                                        simulate_reference)
    from samtools_tpu_torch.tools.index_cmd import main_index
    ref = simulate_reference(SHARD_LEN, seed=SHARD_SEED)
    b = simulate_batch(ref_len=SHARD_LEN, coverage=SHARD_COVERAGE,
                       read_len=READ_LEN, seed=SHARD_SEED + 1, paired=False,
                       ref=ref)
    got = {"bam": os.path.join(workdir, "spans.bam"),
           "fa": os.path.join(workdir, "spans.fa"), "reads": int(b.n)}
    write_bam(got["bam"], make_header(SHARD_LEN), b, threads=THREADS)
    require(main_index([got["bam"]]) == 0, "index of the sharded cell")
    write_fasta(got["fa"], ref)
    return got


def _env_run(argv: list[str], out: str, env: dict) -> float:
    """run_cli on the card with ``env`` set for the run."""
    old = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        return run_cli(argv, out, "-o", False)
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


# a span worker's start, stage by stage: the wall clock (seconds since
# the epoch) after the interpreter's start, ``import torch``, the port's
# command modules, the CUDA context on the worker's device, the kernel
# library's load and a first K14 launch (with its synchronize)
WORKER_STAGES = r"""
import json, sys, time
t = [time.time()]
import torch
t.append(time.time())
from samtools_tpu_torch import cli, kernels
from samtools_tpu_torch.ops.pileup_device import pileup_counts
from samtools_tpu_torch.tools import consensus_cmd, mpileup_cmd
t.append(time.time())
dev = torch.device(sys.argv[1])
x = torch.zeros(1024, dtype=torch.int32, device=dev)
torch.cuda.synchronize(dev)
t.append(time.time())
kernels._load()
t.append(time.time())
pileup_counts(x, x, x >= 0, 64)
torch.cuda.synchronize(dev)
t.append(time.time())
print(json.dumps(t))
"""
STAGES = ("interpreter", "import_torch", "import_port", "cuda_context",
          "kernel_load", "first_launch")


def worker_stages(dev, n: int) -> list[dict]:
    """``n`` span-worker starts at once (processes with a span worker's
    environment, ``tools/common.worker_env``): each one's seconds a stage
    of WORKER_STAGES, the interpreter's counted from the parent's spawn,
    and their total."""
    from samtools_tpu_torch.tools.common import worker_env
    env = worker_env(dev)
    t0 = time.time()
    procs = [subprocess.Popen([sys.executable, "-c", WORKER_STAGES,
                               str(dev)], env=env, stdin=subprocess.DEVNULL,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(n)]
    out = []
    for p in procs:
        got, _ = p.communicate(timeout=120)
        require(p.returncode == 0, "a span worker's start failed")
        t = [t0] + json.loads(got.strip().splitlines()[-1])
        out.append({**{k: round(b - a, 4)
                       for k, a, b in zip(STAGES, t, t[1:])},
                    "total": round(t[-1] - t0, 4)})
    return out


def phase_sharded(workdir: str, bams: dict, dev) -> tuple:
    """K14 against its plain version at entry()'s shape and on clean's
    first 1 Mbp window; the mesh on the one card (make_sharded_pileup on
    (2, 2), depth_window_sharded on 4 shards over clean's front,
    flagstat_counts_sharded on 4 shards over clean), each equal to its
    unsharded run with the launches it must make; then the span workers
    of mpileup -f and consensus on the sharded cell under SAMTPU_SHARDS=1
    and 3, bytes equal, and one worker's command in-process under the
    worker environment, with its launches.  Returns (K14's row, the
    launches of the sharded pileup run)."""
    import torch
    from samtools_tpu_torch import graft_entry, kernels
    from samtools_tpu_torch.io.files import read_alignments
    from samtools_tpu_torch.io.stream import BamStream
    from samtools_tpu_torch.ops import flagstat as fs
    from samtools_tpu_torch.ops import pileup_device as pd
    from samtools_tpu_torch.ops import pileup_engine as pe
    from samtools_tpu_torch.parallel import mesh as M
    t_phase = time.perf_counter()

    # K14 at entry()'s shape and at a depth-like shape
    fn, (rp, ln, ok) = graft_entry.entry()
    rng = np.random.default_rng(SHARD_SEED)
    qual = rng.integers(2, 41, rp.numel()).astype(np.int32)
    shapes = {"entry": (rp.cpu().numpy(), ln.cpu().numpy(),
                        ok.cpu().numpy(), qual, 1 << 14)}
    # clean's reads that start in its first 1 Mbp (all in its front)
    front = read_alignments(bams["clean_front"], THREADS).batch
    c_rp, c_ln, c_q, c_ok = pd.expand_to_device_arrays(
        front, np.nonzero(front.pos < 1 << 20)[0], 0, 1 << 20)
    shapes["clean_1mbp"] = (c_rp, c_ln, c_ok, c_q, 1 << 20)
    rows = {k: _k14_case(dev, *v) for k, v in shapes.items()}
    rows.update({k: _k14_case(dev, *v, full=False) for k, v in
                 k14_hard_shapes(c_rp, c_ln, c_ok, c_q).items()})
    del shapes, c_rp, c_ln, c_q, c_ok
    emit({"phase": "sharded", "run": "k14", **rows})

    # the mesh on the one card
    mesh22 = M.make_mesh(2, 2, [dev] * 4)
    sp, total = pd.make_sharded_pileup(mesh22, (1 << 14) // 2)
    kernels.reset_launches()
    got = sp(rp, ln, ok)
    torch.cuda.synchronize()
    pile_launches = dict(kernels.launches)
    require(pile_launches["pileup_scatter"] == 4,
            f"sharded pileup: K14 {pile_launches['pileup_scatter']} "
            "launches, not one a shard")
    require(torch.equal(got, fn(rp, ln, ok)),
            "sharded pileup differs from the unsharded counts")
    k15 = {"pileup_ms": cuda_ms(lambda: sp(rp, ln, ok)),
           "pileup_unsharded_ms": cuda_ms(lambda: fn(rp, ln, ok))}
    parts = [pd.pileup_counts(rp, ln, ok, 1 << 13) for _ in range(2)]
    k15["pileup_sum_ms"] = cuda_ms(lambda: M.local_sum(mesh22, parts))
    # one library call on the same partials
    k15["pileup_sum_library_ms"] = cuda_ms(
        lambda: torch.stack(parts).sum(0))
    # bounds: each partial read once, the sum written once
    k15["pileup_sum_bound_ms"] = bound(
        (len(parts) + 1) * parts[0].numel() * parts[0].element_size(), 0)[0]

    mesh4 = M.make_mesh(1, 4, [dev] * 4)
    fsel = np.arange(front.n)
    wbeg, wend = int(front.pos.min()), int(front.end_pos().max())
    want = pe.depth_window_device(front, fsel, wbeg, wend, 0, False,
                                  device=dev)
    kernels.reset_launches()
    t0 = time.perf_counter()
    got = M.depth_window_sharded(mesh4, front, fsel, wbeg, wend, 0, False)
    k15["depth_sharded_s"] = time.perf_counter() - t0
    require(kernels.launches["segment_contract"] == 4,
            f"sharded depth: K1 {kernels.launches['segment_contract']} "
            "launches, not one a shard")
    require(np.array_equal(got, want), "sharded depth differs")
    # the gather: the 4 shards' rows of the window's events joined
    diff, _ = pe.depth_items(front, fsel, wbeg, wend, 0, False)
    shard_rows = list(torch.chunk(M.segment_matmul_sharded(mesh4, *diff), 4))
    k15["depth_gather_ms"] = cuda_ms(lambda: torch.cat(shard_rows))
    k15["depth_rows"] = sum(int(r.shape[0]) for r in shard_rows)
    # the shards' rows read once, the joined rows written once
    k15["depth_gather_bound_ms"] = bound(2 * sum(
        r.numel() * r.element_size() for r in shard_rows), 0)[0]
    del front, diff, shard_rows

    n_batches = k11_want = 0
    t_sharded = t_single = 0.0
    kernels.reset_launches()
    with BamStream(bams["clean"], threads=THREADS) as st:
        for part in st.batches(fields=0):
            # one launch unsharded, one a shard that holds records
            per = -(-part.n // 4)
            k11_want += 1 + sum(part.n > s * per for s in range(4))
            t0 = time.perf_counter()
            one = fs.flagstat_counts(part, dev)
            t1 = time.perf_counter()
            many = M.flagstat_counts_sharded(mesh4, part)
            t_sharded += time.perf_counter() - t1
            t_single += t1 - t0
            require(one == many, "sharded flag census differs")
            n_batches += 1
    require(kernels.launches["flagstat"] == k11_want,
            f"flagstat: K11 {kernels.launches['flagstat']} launches over "
            f"{n_batches} batches, not {k11_want}")
    partials = [torch.zeros(16, 2, dtype=torch.int64, device=dev)] * 4
    k15.update(flagstat_batches=n_batches, flagstat_sharded_s=t_sharded,
               flagstat_unsharded_s=t_single,
               flagstat_sum_ms=cuda_ms(lambda: M.local_sum(mesh4,
                                                           partials)),
               flagstat_sum_library_ms=cuda_ms(
                   lambda: torch.stack(partials).sum(0)),
               flagstat_sum_bound_ms=bound(
                   (len(partials) + 1) * partials[0].numel()
                   * partials[0].element_size(), 0)[0])
    emit({"phase": "sharded", "run": "mesh", "shards": 4,
          "pileup_launches": pile_launches, "k15": k15})

    # the span workers on the sharded cell
    cell = write_shard_inputs(workdir)
    emit({"phase": "sharded", "run": "inputs", "contig_len": SHARD_LEN,
          "reads": cell["reads"], "coverage": SHARD_COVERAGE})
    for label, argv in SHARD_RUNS:
        argv = [a.format(**cell) for a in argv]
        walls, outs = {}, {}
        for shards in ("1", str(SHARD_SPANS)):
            out = os.path.join(workdir, f"spans.{shards}.out")
            walls[shards] = _env_run(argv, out, {"SAMTPU_SHARDS": shards})
            with open(out, "rb") as f:
                outs[shards] = f.read()
            os.remove(out)
        require(outs["1"] == outs[str(SHARD_SPANS)] and outs["1"],
                f"{label}: span workers print other bytes than the serial "
                "run")
        # one worker's command in-process, under the worker environment
        span0 = os.path.join(workdir, "span0.out")
        if label.startswith("mpileup"):
            wargv = ["mpileup", "-r", "sim1:1-1048576", *argv[1:]]
            wenv = {"SAMTPU_MPILEUP_SHARD_WORKER": "1"}
            want_k = ("segment_census", "baq_hmm", "baq_finalize")
        else:
            wargv = argv
            wenv = {"SAMTPU_CONSENSUS_SPAN": "0:0:1048576"}
            want_k = ("consensus_segsum", "stable_order")
        kernels.reset_launches()
        wwall = _env_run(wargv, span0, wenv)
        wl = dict(kernels.launches)
        require(all(wl[k] > 0 for k in want_k),
                f"{label} worker: launches {wl}")
        with open(span0, "rb") as f:
            worker = f.read()
        os.remove(span0)
        if label.startswith("mpileup"):
            # the first span's rows open the whole run's
            require(worker and outs["1"].startswith(worker)
                    and int(outs["1"][len(worker):].split(b"\t")[1])
                    > 1 << 20, "mpileup worker: not the run's first rows")
        else:
            head, seq = worker.split(b"\n")[:2]
            body = b"".join(outs["1"].split(b"\n")[1:])
            require(head.startswith(b"#SPANMETA ") and seq
                    and body.startswith(seq),
                    "consensus worker: not the run's first bases")
        emit({"phase": "sharded", "run": label, "reads": cell["reads"],
              "serial_wall_s": round(walls["1"], 3),
              "sharded_wall_s": round(walls[str(SHARD_SPANS)], 3),
              "workers": SHARD_SPANS, "output_bytes": len(outs["1"]),
              "byte_equal": True, "worker_wall_s": round(wwall, 3),
              "worker_launches": wl})
    # where a sharded run's time beyond its workers' work goes: one
    # worker's start alone, then three at once as SAMTPU_SHARDS=3 starts
    emit({"phase": "sharded", "run": "worker_start",
          "alone": worker_stages(dev, 1)[0],
          "three_at_once": worker_stages(dev, SHARD_SPANS)})
    emit({"phase": "sharded", "run": "all",
          "wall_s": round(time.perf_counter() - t_phase, 3)})
    row = dict(rows["entry"], shapes=rows)
    return row, pile_launches


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    from samtools_tpu_torch.sim import simulate_reference
    emit({"phase": "env", "python": sys.version.split()[0],
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "threads": THREADS})
    phase_build()
    ref = simulate_reference(REF_LEN, seed=7)
    ref_int = ref_codes(ref)
    rows = phase_kernels(ref, ref_int, torch.device("cuda"))
    with tempfile.TemporaryDirectory() as workdir:
        launches, oracles, core_census = phase_main(ref, ref_int, workdir)
        tool_launches, (pairs, n_pairs), clean_text = phase_tool(
            ref, workdir, oracles)
        bams = {"clean": oracles["clean"][0], "messy": oracles["messy"][0],
                "pairs": pairs}
        fronts = {}
        for name in ("clean", "messy"):
            bams[f"{name}_front"] = os.path.join(workdir,
                                                 f"{name}_front.bam")
            fronts[f"{name}_front"] = write_front(bams[name],
                                                  bams[f"{name}_front"])
        pile_rows, region_reads = phase_kernels_pileup(
            bams["clean"], torch.device("cuda"))
        family = phase_pileup_family(
            workdir, bams, {"clean": oracles["clean"][3],
                            "messy": oracles["messy"][3], "pairs": n_pairs,
                            "region": region_reads, **fronts})
        general_rows, general, counts = phase_general(
            ref, ref_int, workdir, bams, clean_text, torch.device("cuda"))
        cons_rows, cons, cons_whole = phase_consensus(
            workdir, bams, clean_text,
            {"clean": oracles["clean"][3], "pairs": n_pairs, **counts},
            torch.device("cuda"))
        os.remove(clean_text)
        stats = phase_stats(bams, workdir, {
            "clean": oracles["clean"][3], "pairs": n_pairs, **fronts})
        stats_rows = phase_kernels_stats(bams, ref, ref_int,
                                         torch.device("cuda"), core_census)
        del core_census
        header, cram_reads = phase_regions(workdir, bams, cons, cons_whole)
        cram, cram_bam, cram_path = phase_cram(workdir, ref, header,
                                               cram_reads)
        del cram_reads
        ancillary_tools = start_ancillary_tools(workdir, ref, cram_path,
                                                cram_bam)
        tools = phase_pileup_tools(workdir)
        ancillary_tools()
        phase_view_tools(workdir, bams["clean_front"], cram_bam)
        amplicon_tools = start_amplicon_tools(workdir)
        phase_prep_tools(workdir, bams["clean_front"], bams["pairs"], ref)
        amplicon_tools()
        phase_realign_tools(workdir, bams["pairs"], ref, beside=(
            lambda rg, rg_header, rg_reads: start_header_tools(
                workdir, rg, rg_header, rg_reads, ref, cram_path, cram_bam,
                bams["clean"], bams["messy"])))
        rows["pileup_scatter"], sharded_launches = phase_sharded(
            workdir, bams, torch.device("cuda"))
    import resource

    from samtools_tpu_torch.core.malloc_tune import tune
    emit({"phase": "process", "tune": tune(),
          "peak_rss_mib": round(resource.getrusage(
              resource.RUSAGE_SELF).ru_maxrss / 1024, 1)})
    rows.update(general_rows)
    rows.update(cons_rows)
    rows.update(stats_rows)
    rows.update({k: pile_rows[k] for k in ("depth_scan", "cov_reduce")})
    table = []
    for name, (src, replaces) in KERNEL_META.items():
        r = rows[name]
        # launches: the mpileup command's run on clean (for the generic
        # K1: the pileup family's card runs; for K8 and K13: the general
        # path's streamed mpileup -s -O run); core_launches: the census
        # core's (phase 3)
        row = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces,
               "launches": (general[GENERAL_RUNS[0][0]][name]
                            if name in general_rows
                            else tool_launches["clean"].get(name, 0)),
               "core_launches": launches["clean"][name],
               "max_abs_err": r["max_abs_err"], "ms": r["ms"],
               "b2b_ms": r["b2b_ms"], "plain_ms": r["plain_ms"],
               "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
               "library_ms": r["library_ms"]}
        if r.get("device_ms") is not None:
            # the kernel alone: a CUDA graph of its calls
            row["device_ms"] = r["device_ms"]
        if name in ("apply_expand", "depth_scan", "cov_reduce"):
            row.update(library_note=r["library_note"], detail=r["detail"])
        if name == "depth_scan":
            # launches: depth on clean (one window); the bound's two
            # parts, and the link's at the pinned rate measured
            row.update(launches=family["depth clean"]["depth_scan"],
                       run_launches={k: v.get(name, 0)
                                     for k, v in family.items()},
                       **{k: r[k] for k in (
                           "bound_hbm_ms", "bound_link_ms",
                           "bound_link_measured_ms", "link_bytes",
                           "link_GBps", "device_ms_into_card", "edges")})
        if name == "cov_reduce":
            # launches: coverage on clean (a launch a streamed window)
            row.update(launches=family["coverage clean"]["cov_reduce"],
                       run_launches={k: v.get(name, 0)
                                     for k, v in family.items()},
                       edges=r["edges"])
        if name == "baq_apply":
            row.update(host_baq_batch_ms=r["host_baq_batch_ms"],
                       bound_sum_k4_ops_k5_bytes_ms=r[
                           "bound_sum_k4_ops_k5_bytes_ms"],
                       general_launches={k: v[name]
                                         for k, v in general.items()})
        if name == "apply_expand":
            row["general_launches"] = {k: v[name] for k, v in general.items()}
        if name in ("baq_apply", "apply_expand", "stable_order"):
            # the pileup_tools phase's card runs
            row["pileup_tools_launches"] = {k: v[name]
                                            for k, v in tools.items()}
        if name == "stable_order":
            row.update(host_argsort_ms=r["host_argsort_ms"],
                       general_launches={k: v[name]
                                         for k, v in general.items()},
                       consensus_launches={k: v[name]
                                           for k, v in cons.items()})
        if name in ("consensus_segsum", "flagstat"):
            # launches: consensus -r on clean; flagstat on clean
            row.update(launches=cons[CONSENSUS_RUNS[0][0] if name ==
                                     "consensus_segsum" else "flagstat"][
                                         name],
                       run_launches={k: v[name] for k, v in cons.items()},
                       host_ms=r.get("host_gap5_scores_ms",
                                     r.get("host_flagstat_numpy_ms")),
                       detail=r["detail"])
        if name == "flagstat":
            row.update(ballot_form=r["ballot_form"],
                       shapes={k: {f: v[f] for f in (
                           "ms", "b2b_ms", "device_ms", "plain_ms",
                           "library_ms", "host_flagstat_numpy_ms",
                           "bound_ms", "ballot_form", "detail")}
                           for k, v in r["shapes"].items()})
        if name == "consensus_segsum":
            row.update(shapes={k: {f: v[f] for f in (
                           "ms", "b2b_ms", "device_ms", "plain_ms",
                           "library_ms", "host_gap5_scores_ms", "bound_ms",
                           "bound_by", "detail")}
                           for k, v in r["shapes"].items()})
        if name == "stats_hists":
            # launches: stats on clean (every 65,536-record chunk)
            row.update(launches=stats[f"{STATS_RUNS[0][0]} clean"][name],
                       run_launches={k: v[name] for k, v in stats.items()},
                       host_ms=r["host_stats_orig_hists_ms"],
                       chunks={k: {f: v[f] for f in (
                           "ms", "b2b_ms", "device_ms", "plain_ms",
                           "library_ms", "host_stats_orig_hists_ms",
                           "bound_ms", "detail")}
                           for k, v in r["chunks"].items()})
        if name == "census_narrow":
            # launches: the census core's finish() on clean (one launch);
            # the mpileup command fetches per-window checksums instead
            row.update(launches=launches["clean"][name],
                       two_pass_form=r["two_pass_form"],
                       censuses={k: {f: v[f] for f in (
                           "ms", "b2b_ms", "device_ms", "plain_ms",
                           "library_ms", "bound_ms", "two_pass_form",
                           "detail")}
                           for k, v in r["censuses"].items()})
        if name == "segment_contract":
            row.update(launches=sum(v.get(name, 0) for v in family.values()),
                       depth_launches=family["depth clean"][name],
                       coverage_launches=family["coverage clean"][name],
                       at_pileup_shapes={k: pile_rows[k] for k in
                                         ("depth", "coverage")})
        if name == "pileup_scatter":
            # launches: make_sharded_pileup on the (2, 2) mesh of the card
            # its tiled entry (pileup_counts_tiled) lies on no path: the
            # JAX package calls it nowhere, so its launches there are 0
            tiled = {"name": "pileup_tiled", "route": "cuda", "source": src,
                     "replaces": "samtools_tpu/ops/pileup_device.py:55",
                     "launches": sharded_launches["pileup_tiled"],
                     **r["tiled"]}
            row.update(launches=sharded_launches[name],
                       qual_sums_ms=r["qual_sums_ms"], tiled=tiled,
                       device_ms=r["device_ms"], detail=r["detail"],
                       shapes=r["shapes"])
        if name in ("census_checksum", "chunk_expand", "qual_deltas"):
            # launches: the mpileup command on clean (K7 a window, K6's
            # front and tail a device chunk); core_launches: the census
            # core's (K7 in finish_checksum, K6's front a chunk)
            row["detail"] = r["detail"]
        if name == "census_checksum":
            row["windows"] = r["windows"]
        if name in ("chunk_expand", "qual_deltas"):
            row["checks"] = r["checks"]
        if name == "chunk_expand":
            row["library_note"] = r["library_note"]
        cram_launches = {k: v[name] for k, v in cram.items() if v[name]}
        if cram_launches:
            # the cram phase's runs on the CRAM input
            row["cram_launches"] = cram_launches
        require(row["launches"] > 0, f"{name} never launched on its path")
        table.append(row)
    emit({"kernels": table})
    emit({"phase": "done", "wall_s": round(time.perf_counter() - t_start, 1),
          "limit_s": 1200})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
