"""The benchmark's genotype cohort: a frozen NumPy generator and .bed writer.

Frozen copy of the NumPy path of `pyrhe_tpu_torch.io.synth.make_dataset_fast`
(HWE genotypes at uniform MAFs, thresholds quantized to 1/256, missing
genotypes scattered at a fixed rate, one-hot annotation bins) and of the
PLINK .bed encoding of `pyrhe_tpu_torch.io.bed.encode_dosage`, so that a
later change to the port's generator cannot move the yardstick. The
phenotype is not written here: it varies with the run's seed (inputs.py).

Genotypes depend only on the geometry and `geno_seed`; chunk c of SNPs
draws from `np.random.default_rng([geno_seed, 1, c])`, so the file is the
same whatever the number of worker processes. A cohort is written once per
checkout under `h100_bench/.cache/cohort-<key>/`, where the key hashes the
geometry and GENERATOR_VERSION; later runs reuse it.

    python -m h100_bench.cohort --out DIR --geometry '{"num_indiv": ...}'

writes one (run.py starts it as a child process, so its memory does not
count in the run's peak host memory).
"""
from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import shutil

import numpy as np

GENERATOR_VERSION = 1
CHUNK = 1024                     # SNPs per generated chunk
MAGIC = bytes([0x6C, 0x1B, 0x01])
# dosage 0, 1, 2 -> PLINK 2-bit code 00, 10, 11; missing (255) -> 01
_CODE = np.zeros(256, dtype=np.uint8)
_CODE[[0, 1, 2, 255]] = [0b00, 0b10, 0b11, 0b01]
GEOMETRY_KEYS = ("num_indiv", "num_snp", "num_bin", "missing_rate",
                 "maf_range", "geno_seed")


def geometry(config: dict) -> dict:
    """The keys of a configuration that fix its cohort."""
    return {k: config[k] for k in GEOMETRY_KEYS}


def key(geo: dict) -> str:
    blob = json.dumps({**geo, "version": GENERATOR_VERSION}, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def encode(dosage: np.ndarray) -> np.ndarray:
    """(m, n) uint8 dosages (255 = missing), n % 4 == 0 -> (m, n/4) packed
    .bed bytes, individual i in bits 2(i % 4) of byte i // 4."""
    c = _CODE[dosage]
    return (c[:, 0::4] | (c[:, 1::4] << 2) | (c[:, 2::4] << 4)
            | (c[:, 3::4] << 6)).astype(np.uint8)


def _mafs_annot(geo: dict):
    rng = np.random.default_rng([geo["geno_seed"], 0])
    lo, hi = geo["maf_range"]
    mafs = rng.uniform(lo, hi, size=geo["num_snp"])
    annot = np.zeros((geo["num_snp"], geo["num_bin"]), dtype=np.int64)
    annot[np.arange(geo["num_snp"]),
          rng.integers(0, geo["num_bin"], size=geo["num_snp"])] = 1
    return mafs, annot


def _chunk(args) -> bytes:
    geo, c, mafs = args
    n = geo["num_indiv"]
    rng = np.random.default_rng([geo["geno_seed"], 1, c])
    p = mafs[:, None].astype(np.float32)
    t2 = np.floor(p * p * 256).astype(np.uint8)
    t12 = np.floor((p * p + 2 * p * (1 - p)) * 256).astype(np.uint8)
    u = rng.integers(0, 256, size=(len(mafs), n), dtype=np.uint8)
    geno = (u < t2).astype(np.uint8)
    geno += u < t12
    if geo["missing_rate"] > 0:
        n_miss = rng.binomial(geno.size, geo["missing_rate"])
        geno.ravel()[rng.integers(0, geno.size, size=n_miss)] = 255
    return encode(geno).tobytes()


def write(out_dir: str, geo: dict) -> str:
    """Write <out_dir>/cohort.{bed,bim,fam,annot} for the geometry, into a
    sibling directory renamed into place when complete; returns the
    prefix. A pool of up to 8 processes generates the chunks."""
    if geo["num_indiv"] % 4:
        raise ValueError("num_indiv must be a multiple of 4")
    tmp = out_dir + ".part"
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    prefix = os.path.join(tmp, "cohort")
    mafs, annot = _mafs_annot(geo)
    M = geo["num_snp"]
    jobs = [(geo, c, mafs[s:s + CHUNK])
            for c, s in enumerate(range(0, M, CHUNK))]
    ctx = multiprocessing.get_context("spawn")
    with open(prefix + ".bed", "wb") as f, \
            ctx.Pool(min(8, os.cpu_count() or 1)) as pool:
        f.write(MAGIC)
        for blob in pool.imap(_chunk, jobs):
            f.write(blob)
        # on the disk before the first window opens: the kernel's delayed
        # write-back of 2.5 GB would otherwise land in it, 30 s later
        f.flush()
        os.fsync(f.fileno())
    with open(prefix + ".bim", "w") as f:
        f.writelines(f"1\trs{i}\t0\t{i}\tA\tG\n" for i in range(M))
    with open(prefix + ".fam", "w") as f:
        f.writelines(f"{i} 1 0 0 0 -9\n" for i in range(geo["num_indiv"]))
    np.savetxt(prefix + ".annot", annot, fmt="%d", delimiter=" ")
    shutil.rmtree(out_dir, ignore_errors=True)
    os.replace(tmp, out_dir)
    return os.path.join(out_dir, "cohort")


def annotation(geo: dict) -> np.ndarray:
    """The (num_snp, num_bin) one-hot annotation the cohort was written
    with."""
    return _mafs_annot(geo)[1]


def main(argv=None):
    ap = argparse.ArgumentParser(description="write one benchmark cohort")
    ap.add_argument("--out", required=True)
    ap.add_argument("--geometry", required=True, help="JSON object")
    args = ap.parse_args(argv)
    write(args.out, json.loads(args.geometry))


if __name__ == "__main__":
    main()
