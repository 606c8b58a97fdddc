"""SynDCIM core on torch: the compiler's main path.

Layers (paper Fig. 2), each the counterpart of the module of the same name
in the JAX package's ``repro.core``:
  tech        40nm technology + voltage-scaling model (calibrated to silicon)
  subcircuits the seven DCIM subcircuit types and their PPA models
  csa         mixed compressor/FA carry-save adder-tree family (Fig. 4)
  scl         Subcircuit Library: characterized PPA lookup tables (Fig. 3)
  searcher    Multi-Spec-Oriented searcher — Algorithm 1 (scalar oracle)
  pareto      Pareto-frontier utilities (Fig. 8), host and device masks
  axes        the lattice axis registry and ``LatticeConfig``
  batched     the whole design lattice in one float64 pass on a device
  engine      unified execution engine: plan -> place -> execute -> extract
  multispec   N specs in one spec-stacked pass
  macro       spec -> design -> PPA roll-up (+ silicon calibration)
  netlist     RTL / structural netlist emission
  gatesim     functional gate-level simulation of synthesized trees
  layout      SDP-style structured placement (DEF, SDP script)
  dse         system-level workload -> macro-array mapping, co-design
"""

from .axes import LatticeConfig
from .batched import (BatchedPPA, BatchedSweep, DesignLattice, SpecTables,
                      design_space_sweep, evaluate, mso_search_batched,
                      pareto_mask)
from .csa import CSADesign, CSAReport, FAMILY, build_netlist, characterize
from .dse import (AcceleratorReport, CodesignReport, GemmShape,
                  WorkloadMatrix, accelerator_report,
                  batched_workload_matrix, cross_workload_codesign,
                  gemm_inventory, map_gemm)
from .engine import (ExecutionPlan, PackedGroup, Placement, Strategy,
                     execute, extract_frontier, register_strategy)
from .gatesim import simulate, verify_tree
from .layout import Floorplan, Region, emit_def, emit_sdp_script, place
from .macro import (MacroDesign, MacroPPA, MacroSpec, at_voltage,
                    calibrated_tech_for_reference, pareto_experiment_spec,
                    reference_chip_design, reference_chip_ppa,
                    reference_chip_spec, reporting_frequency, rollup,
                    timing_paths)
from .netlist import emit_verilog, tree_netlist
from .multispec import (design_space_sweep_many, evaluate_many,
                        frontier_union, mso_search_many, scenario_specs)
from .pareto import (PARETO_EPS, dominates, nondominated_mask,
                     nondominated_mask_auto, pareto_chunk_size, pareto_front,
                     pareto_indices, preference_grid)
from .scl import SubcircuitLibrary
from .searcher import SearchResult, mso_search, synthesize_one
from .subcircuits import SC, MemCellKind, MultMuxKind, PPA
from .tech import TechModel, delay_scale, energy_scale

__all__ = [
    "LatticeConfig",
    "BatchedPPA", "BatchedSweep", "DesignLattice", "SpecTables",
    "design_space_sweep", "evaluate", "mso_search_batched", "pareto_mask",
    "CSADesign", "CSAReport", "FAMILY", "build_netlist", "characterize",
    "AcceleratorReport", "CodesignReport", "GemmShape", "WorkloadMatrix",
    "accelerator_report", "batched_workload_matrix",
    "cross_workload_codesign", "gemm_inventory", "map_gemm",
    "ExecutionPlan", "PackedGroup", "Placement", "Strategy", "execute",
    "extract_frontier", "register_strategy",
    "simulate", "verify_tree",
    "Floorplan", "Region", "emit_def", "emit_sdp_script", "place",
    "emit_verilog", "tree_netlist",
    "MacroDesign", "MacroPPA", "MacroSpec", "at_voltage",
    "calibrated_tech_for_reference", "pareto_experiment_spec",
    "reference_chip_design", "reference_chip_ppa", "reference_chip_spec",
    "reporting_frequency", "rollup", "timing_paths",
    "design_space_sweep_many", "evaluate_many", "frontier_union",
    "mso_search_many", "scenario_specs",
    "PARETO_EPS", "dominates", "nondominated_mask", "nondominated_mask_auto",
    "pareto_chunk_size", "pareto_front", "pareto_indices", "preference_grid",
    "SubcircuitLibrary",
    "SearchResult", "mso_search", "synthesize_one",
    "SC", "MemCellKind", "MultMuxKind", "PPA",
    "TechModel", "delay_scale", "energy_scale",
]
