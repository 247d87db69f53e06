"""``python -m samtools_tpu_torch cram-size`` against ``python -m
samtools_tpu cram-size``, on the CPU (one parity test over the table of
cases, ``torch_tool_fixtures.check_case``: exit code, standard error,
standard output and every file), and the port's ``core/khash_sim.py``
against ``samtools_tpu/core/khash_sim.py`` directly.

Inputs are ``torch_tool_fixtures.make_header_inputs``'s: CRAM 3.0 from
the JAX writer (``grouped_cram``: 2,000 collated pairs with read groups;
``general_cram``: reads with aux fields of many types, so ``-e`` lists
many tag encodings; ``cram``: 200 messy reads) and ``grouped_cram31``,
the 3.1 twin.  A truncated copy and a file that is not CRAM are made
beside each case.  No case launches a kernel.
"""

import os

import numpy as np
import pytest
from torch_tool_fixtures import (check_case, jax_case_runs,
                                 make_header_inputs, run_jax_full,
                                 run_port_case)

from samtools_tpu.core import khash_sim as jkhash
from samtools_tpu_torch import kernels
from samtools_tpu_torch.core import khash_sim

# name -> (arguments, standard input); {x} names an input of the fixture,
# {o} the case's output directory
CASES = {
    "plain30": (["{grouped_cram}"], None),
    "plain31": (["{grouped_cram31}"], None),
    "verbose30": (["-v", "{grouped_cram}"], None),
    "verbose31": (["--verbose", "{grouped_cram31}"], None),
    "encodings30": (["-e", "{grouped_cram}"], None),
    "encodings31": (["--encodings", "{grouped_cram31}"], None),
    "verbose_encodings_tags": (["-v", "-e", "{general_cram}"], None),
    "encodings_messy": (["-e", "{cram}"], None),
    "output": (["-o", "{o}/x.size", "-v", "{grouped_cram}"], None),
    "output_long": (["--output", "{o}/x.size", "-e", "{grouped_cram31}"],
                    None),
    "output_bad": (["-o", "{dir}/no_dir/x.size", "{grouped_cram}"], None),
    "stdin": (["-v", "-"], "grouped_cram31"),
    "stdin_implied": (["-e"], "general_cram"),
    "truncated_in_header": (["{o}/cut_head.cram"], None),
    "bad_method": (["-v", "{o}/flip26.cram"], None),
    "not_cram": (["{general}"], None),
    "missing": (["{dir}/none.cram"], None),
    "bad_option": (["--no-such", "{grouped_cram}"], None),
}
# cases whose run raises this exception in both packages (a traceback:
# only CramError, CramCodecError and NotImplementedError are caught)
RAISES = {
    "truncated": (["-v", "{o}/cut.cram"], "IndexError"),
}
ALL = {**CASES, **{k: (v[0], None) for k, v in RAISES.items()}}


def _cut_copies(inputs):
    """Broken copies of ``grouped_cram`` in each case's directory: cut
    two thirds in (inside a data container) and inside its header
    container, and with byte 26 (the header block's method) flipped to
    a method no codec takes."""
    def prepare(odir):
        with open(inputs["grouped_cram"], "rb") as f:
            data = f.read()
        copies = {"cut.cram": data[:len(data) * 2 // 3],
                  "cut_head.cram": data[:60]}
        flip = bytearray(data)
        flip[26] ^= 0xFF
        copies["flip26.cram"] = bytes(flip)
        for name, blob in copies.items():
            with open(os.path.join(odir, name), "wb") as f:
                f.write(blob)
    return prepare


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    return make_header_inputs(str(tmp_path_factory.mktemp("cram_size")))


@pytest.fixture(scope="module")
def want(inputs):
    return jax_case_runs("cram-size", inputs, ALL, _cut_copies(inputs))


@pytest.mark.parametrize("case", sorted(CASES))
def test_cram_size_equals_jax_tool(inputs, want, case):
    kernels.reset_launches()
    check_case(run_port_case("cram-size", inputs, CASES, case,
                             _cut_copies(inputs)), want[case], case)
    assert not any(kernels.launches.values())


@pytest.mark.parametrize("case", sorted(RAISES))
def test_cram_size_raises_as_jax_tool(inputs, want, case):
    (rc, out, err, _), _ = want[case]
    kind = RAISES[case][1]
    assert rc == 1 and kind in err.strip().splitlines()[-1]
    with pytest.raises(Exception) as exc:
        run_port_case("cram-size", inputs, ALL, case, _cut_copies(inputs))
    assert type(exc.value).__name__ == kind
    assert err.strip().splitlines()[-1].endswith(f"{kind}: {exc.value}")


@pytest.mark.parametrize("key", ["grouped_cram", "grouped_cram31",
                                 "general_cram"])
def test_sizes_add_up(inputs, key):
    """The compressed sizes are within the file, and ``-v`` has a row for
    every content ID of the short report."""
    short = run_port_case("cram-size", inputs, {"x": (["{%s}" % key],
                                                      None)}, "x")
    long = run_port_case("cram-size", inputs, {"x": (["-v", "{%s}" % key],
                                                     None)}, "x")
    assert short[0] == long[0] == 0

    def blocks(out):
        rows = [ln.split() for ln in out.decode().splitlines()
                if ln.startswith("BLOCK")]
        return {r[1] for r in rows}, sum(int(r[3]) for r in rows)
    ids, comp = blocks(short[1])
    vids, vcomp = blocks(long[1])
    assert ids == vids and comp == vcomp > 0
    assert comp <= os.path.getsize(inputs[key])
    assert "CORE" in ids


def test_help_equals_jax_tool(inputs):
    got = run_port_case("help", inputs, {"x": (["cram-size"], None)}, "x")
    assert got[:3] == run_jax_full("help", ["cram-size"])


# the port's core/khash_sim.py against the JAX module
@pytest.mark.parametrize("n", [1, 3, 4, 8, 16, 17, 64, 200, 1024, 1025])
def test_khash_order_of_int_keys_equals_jax(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 1 << 24, n).tolist()
    keys += keys[: n // 3]  # duplicates
    mine = khash_sim.khash_order(keys)
    assert mine == jkhash.khash_order(keys)
    assert sorted(mine) == sorted(set(keys))
    # three-letter tag keys, as cram-size -e gives them
    tags = [(ord("A") + k % 26) << 16 | (ord("a") + k // 26 % 26) << 8
            | ord("Z") for k in rng.integers(0, 676, n).tolist()]
    assert khash_sim.khash_order(tags) == jkhash.khash_order(tags)


@pytest.mark.parametrize("n", [4, 8, 16, 32, 100, 512])
def test_khash_order_of_tag_keys_equals_jax(n):
    """Three-letter tag keys (cram-size -e's), drawn from a few names so
    that most repeat, in counts around each resize."""
    rng = np.random.default_rng(100 + n)
    names = rng.integers(0, 26 * 26, max(n // 2, 2)).tolist()
    keys = [(ord("A") + k % 26) << 16 | (ord("a") + k // 26) << 8
            | ord("BZi"[k % 3]) for k in rng.choice(names, n).tolist()]
    keys += keys[::5]
    mine = khash_sim.khash_order(keys)
    assert mine == jkhash.khash_order(keys)
    assert len(mine) == len(set(keys))


def test_khash_buckets_follow_resizes():
    """Every insert lands where the JAX simulator puts it, through each
    resize (4, 8, 16 ... 2,048 buckets)."""
    mine, want = khash_sim.KHash(), jkhash.KHash()
    sizes = set()
    for k in range(1500):
        key = (k * 2654435761) & 0xFFFFFF
        assert mine.put(key) == want.put(key)
        assert mine.n_buckets == want.n_buckets
        sizes.add(mine.n_buckets)
    assert sizes >= {4, 8, 16, 32, 64, 128, 256, 512, 1024, 2048}
    assert list(mine.iter_keys()) == list(want.iter_keys())
