#!/usr/bin/env python3
"""Whether a fleet's batched calibration stays bit-identical to each
chip's own, on one device, with each chip's products by its own call and
with one product batched over the chips:

    python3 scripts/fleet_order.py [--chips 130] [--device cuda]

``calibrate_fleet`` (``repro_torch.fleet``) measures every chip of a
:class:`~repro_torch.fleet.placement.ChipFleet` in one batched pass and
promises that chip i's tables equal ``calibrate_chip`` on a fresh twin of
chip i (the same seed), bit for bit: a twin spare then restores a dead
chip's outputs exactly.  ``placement._chip_products`` computes each
chip's chunk products by its own einsum call (``shipped``); the variant
``batched_product`` makes one einsum over the device axis instead.  The
fits reduce over the stacked tensors with ``Tensor.mean`` / ``sum``.

For each noise model (none, as ``chip_smoke.py``'s fleet phase measures,
and the default readout noise) and each variant, the script
builds a fleet of ``--chips`` chips at that phase's geometry (64 slots of
128 x 512 synapses, so a block of chips is 128 chips and 130 chips span
two blocks), calibrates it with the phase's repeats (offsets 4, gain 1)
and with the defaults (64, 8), calibrates fresh twins of chips 0, 1, 127
and 129 alone, and counts the table entries that differ.  Prints one
JSON line per case and writes them to ``chiprun_out/fleet_order.json``.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SLOTS, ROWS, COLS = 64, 128, 512


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, default=130)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch import fleet
    from repro_torch.calib import routines
    from repro_torch.calib.device import VirtualChip
    from repro_torch.core.noise import NoiseConfig
    from repro_torch.fleet import placement

    dev = torch.device(args.device)

    def batched(a_c, w_c):
        return torch.einsum("...ck,dckn->d...cn", a_c, w_c)

    variants = {"shipped": placement._chip_products,
                "batched_product": batched}
    noises = {"none": NoiseConfig(readout_std=0.0), "default": NoiseConfig()}
    repeats = {"phase": (4, 1), "default": (64, 8)}
    check = sorted({0, 1, min(127, args.chips - 1), args.chips - 1})
    lines = []
    for nname, noise in noises.items():
        for rname, (r_off, r_gain) in repeats.items():
            for vname, products in variants.items():
                placement._chip_products = products
                gen = torch.Generator(device=dev).manual_seed(0)

                def chip(i):
                    return VirtualChip(
                        routines.chip_generator(gen, i, dev), SLOTS * ROWS,
                        COLS, noise=noise, chunk_rows=ROWS)

                fl = fleet.ChipFleet([chip(i) for i in range(args.chips)])
                fs = fleet.calibrate_fleet(fl, offset_repeats=r_off,
                                           gain_repeats=r_gain)
                diff = {}
                for i in check:
                    rec = routines.calibrate_chip(
                        chip(i), offset_repeats=r_off, gain_repeats=r_gain)
                    diff[i] = {
                        "gain": int((fs.gain_table[i]
                                     != rec.gain_table).sum()),
                        "offset": int((fs.chunk_offset[i]
                                       != rec.chunk_offset).sum())}
                line = {"noise": nname, "repeats": rname, "variant": vname,
                        "chips": args.chips,
                        "entries_per_table": int(fs.gain_table[0].numel()),
                        "differing_entries": diff,
                        "bit_identical": all(
                            d["gain"] == 0 and d["offset"] == 0
                            for d in diff.values())}
                print(json.dumps(line), flush=True)
                lines.append(line)
                del fl, fs
    placement._chip_products = variants["shipped"]
    out = pathlib.Path("chiprun_out")
    out.mkdir(exist_ok=True)
    (out / "fleet_order.json").write_text(json.dumps(
        {"device": str(dev), "cases": lines}, indent=1))


if __name__ == "__main__":
    main()
