"""Small cells for the CPU tests: a cell of the benchmark cut to reads a
plain CPU pass counts in seconds (the same locus, allele shapes scaled
down, short backbone)."""
from harness import spec

ALIGN = {"dist_offset": 16.0, "dist_min": 0.0, "gap_open_h": -1.0, "gap_open_v": -16.0,
         "gap_extension_h": -1.0, "gap_extension_v": -16.0, "samples": 6}


def small_cell(name: str, reads: int = 3, batch: int = 2) -> dict:
    cell = spec.cell(name)
    cell["params"] = dict(cell["params"], reads=reads, flank_bases=[60, 120])
    cell["params"]["alleles"] = [dict(a, units=[4, 10], draw="uniform")
                                 for a in cell["params"]["alleles"]]
    cell["batch_size"] = batch
    cell["check_reads"] = 2
    return cell


def small_mod_cell(name: str, reads: int = 3, batch: int = 2, shift_pA: float = -4.0) -> dict:
    """``small_cell`` with a 5mC twin in its configuration and half the
    reads of each allele methylated in every unit."""
    cell = small_cell(name, reads, batch)
    cell["config_spec"] = dict(cell["config_spec"], mod_model={"shift_pA": shift_pA})
    for a in cell["params"]["alleles"]:
        a["methylation"] = {"reads": 0.5, "units": 1.0}
    return cell
