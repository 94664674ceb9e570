"""Table 2 and the Discussion's timing: AlexNet on an RPU chip.

The port's counterpart of the JAX package's ``benchmarks/table2_alexnet.py``
on :mod:`repro_torch.core.perfmodel`: the paper's table (array sizes,
weight-sharing factors, MACs), the conventional chip's time (total MACs
over a throughput) against the pipelined RPU chip's (the largest ws x
t_meas), the bimodal small-array design and the 2-array split of the
bottleneck layer.  Model arithmetic only: no device is timed.

    python -m repro_torch.benchmarks.table2_alexnet
"""

from __future__ import annotations

from repro_torch.core import perfmodel as pm


def run(csv: bool = False):
    layers = pm.alexnet_layers()
    chip = pm.RPUChipSpec()            # uniform 80 ns arrays (paper baseline)
    chip_bimodal = pm.RPUChipSpec(bimodal=True)

    total_macs = sum(l.macs for l in layers)
    print("\n=== Table 2: AlexNet on RPU arrays ===")
    print(f"{'layer':>6} {'array (MxN)':>14} {'ws':>6} {'MACs(M)':>9} "
          f"{'t_layer(us)':>12}")
    for l in layers:
        print(f"{l.name:>6} {f'{l.rows} x {l.cols}':>14} "
              f"{l.weight_sharing:>6} {l.macs / 1e6:>9.0f} "
              f"{pm.layer_time(l, chip) * 1e6:>12.1f}")
    print(f"total MACs = {total_macs / 1e9:.2f} G  (paper: 1.14 G)")

    t_rpu, bottleneck = pm.image_time_rpu(layers, chip)
    # the conventional chip at a 10 TMAC/s peak: the paper's argument is
    # relative, the throughput only sets the scale
    t_conv = pm.image_time_conventional(layers, throughput_macs=10e12)
    ws = {l.name: l.weight_sharing for l in layers}
    print(f"\nRPU pipelined time/image: {t_rpu * 1e6:.1f} us "
          f"(bottleneck: {bottleneck}, ws={ws[bottleneck]})")
    print(f"Conventional 10-TMAC/s chip: {t_conv * 1e6:.1f} us "
          f"(sum over layers; K2 = {100 * 448e6 / total_macs:.0f}% of MACs)")

    # bimodal arrays: K1 (96x363) fits the small fast array (80 -> 10 ns)
    t_bi, bn_bi = pm.image_time_rpu(layers, chip_bimodal)
    k1 = layers[0]
    print(f"\nBimodal design: K1 layer time "
          f"{pm.layer_time(k1, chip) * 1e6:.1f} -> "
          f"{pm.layer_time(k1, chip_bimodal) * 1e6:.1f} us; "
          f"time/image {t_rpu * 1e6:.1f} -> {t_bi * 1e6:.1f} us "
          f"(bottleneck: {bn_bi})")

    # or split the bottleneck layer (K1) across 2 arrays (ws / 2)
    split = pm.split_bottleneck(layers, 2, chip)
    t_split, bn2 = pm.image_time_rpu(split, chip)
    print(f"Alternative: 2-array split of {bottleneck}: time/image "
          f"{t_split * 1e6:.1f} us (new bottleneck: {bn2})")

    if csv:
        print("\nname,us_per_call,derived")
        print(f"table2_rpu_image,{t_rpu * 1e6:.3f},bottleneck={bottleneck}")
        print(f"table2_rpu_split2,{t_split * 1e6:.3f},bottleneck={bn2}")
    return {"t_rpu_us": t_rpu * 1e6, "bottleneck": bottleneck,
            "t_split_us": t_split * 1e6, "total_macs": total_macs}


if __name__ == "__main__":
    run(csv=True)
