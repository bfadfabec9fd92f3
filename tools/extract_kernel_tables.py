#!/usr/bin/env python3
"""One-time extractor: collision-efficiency tables -> npz device constants.

The reference ships six tabulated collision-efficiency datasets (Hall 1980,
Hall/Davis without van der Waals forces, Hall/Pinsky at three regimes, and
Vohl/Davis) as ~2 kLoC C++ initializer lists each
(reference src/detail/kernel_definitions/*.hpp), packed triangularly and
indexed by detail::kernel_index (1 um steps to 100 um, 10 um steps above;
src/detail/kernel_utils.hpp:12-29).

This script parses those published *data* tables once and stores each as a
dense symmetric (n_idx, n_idx) float32 matrix in
libcloudphxx_tpu/lgrngn/kernel_data/ — the layout where the
pairwise lookup is a vectorized 2-D gather instead of branchy triangular
indexing.

Usage: python tools/extract_kernel_tables.py [reference_root]
"""

import os
import re
import sys

import numpy as np

TABLES = {
    "hall": "hall_efficiencies.hpp",
    "hall_davis_no_waals": "hall_davis_no_waals_efficiencies.hpp",
    "hall_pinsky_1000mb_grav": "hall_pinsky_1000mb_grav_efficiencies.hpp",
    "hall_pinsky_cumulonimbus": "hall_pinsky_cumulonimbus_efficiencies.hpp",
    "hall_pinsky_stratocumulus": "hall_pinsky_stratocumulus_efficiencies.hpp",
    "vohl_davis_no_waals": "vohl_davis_no_waals_efficiencies.hpp",
}


def kernel_index(r_um):
    return int(r_um) if r_um <= 100 else int(100 + (r_um - 100) / 10)


def main():
    ref = sys.argv[1] if len(sys.argv) > 1 else "/root/reference"
    src_dir = os.path.join(ref, "src", "detail", "kernel_definitions")
    out_dir = os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "libcloudphxx_tpu", "lgrngn", "kernel_data",
    )
    os.makedirs(out_dir, exist_ok=True)

    for name, fname in TABLES.items():
        text = open(os.path.join(src_dir, fname)).read()
        m = re.search(r"_r_max\(\)\s*\{\s*return\s+([0-9.e+-]+)\s*;", text)
        r_max = float(m.group(1))
        m = re.search(r"const real_t arr\[\]\s*=\s*\{(.*?)\};", text, re.S)
        vals = np.array(
            [float(v) for v in m.group(1).replace("\n", " ").split(",")
             if v.strip()],
            dtype=np.float64,
        )
        n_idx = kernel_index(r_max) + 1
        expect = n_idx * (n_idx + 1) // 2
        assert vals.size == expect, (name, vals.size, expect, n_idx)

        # unpack triangular (i>=j: 0.5 i (i+1) + j) into dense symmetric
        dense = np.zeros((n_idx, n_idx), dtype=np.float32)
        for i in range(n_idx):
            base = i * (i + 1) // 2
            dense[i, : i + 1] = vals[base: base + i + 1]
            dense[: i + 1, i] = vals[base: base + i + 1]

        np.savez_compressed(
            os.path.join(out_dir, f"{name}.npz"),
            efficiencies=dense,
            r_max_um=np.float64(r_max),
        )
        print(f"{name}: n_idx={n_idx} r_max={r_max} um "
              f"-> {name}.npz ({dense.nbytes/1024:.0f} KiB dense)")


if __name__ == "__main__":
    main()
