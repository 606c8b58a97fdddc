"""RTL / structural-netlist emission for synthesized macros (paper Fig. 2:
"Architecture RTL, subcircuit RTL and netlist").

Two outputs:
  * :func:`emit_verilog` — a Verilog-flavored, human-auditable RTL of the full
    macro: structural gate instances for the synthesized adder tree (the
    paper's custom subcircuit) and behavioral templates for the parameterized
    digital blocks (S&A, OFU, alignment), mirroring §III-B's split between
    custom cells and RTL templates.
  * :func:`tree_netlist` — the *executable* structural netlist consumed by
    :mod:`repro_torch.core.gatesim` for functional verification.
"""

from __future__ import annotations

import textwrap

from .csa import TreeNetlist, build_netlist
from .macro import MacroDesign, MacroPPA


def tree_netlist(design: MacroDesign) -> TreeNetlist:
    h_eff = design.spec.h // max(1, design.csa.split)
    return build_netlist(design.csa, h_eff)


def _tree_instances(nl: TreeNetlist) -> str:
    lines = []
    for i, g in enumerate(nl.gates):
        if g.kind == "FA":
            lines.append(f"  FA u_fa{i} (.a({g.ins[0]}), .b({g.ins[1]}), "
                         f".ci({g.ins[2]}), .s({g.outs[0]}), .co({g.outs[1]}));")
        elif g.kind == "C42":
            lines.append(f"  CSA42 u_c42_{i} (.a({g.ins[0]}), .b({g.ins[1]}), "
                         f".c({g.ins[2]}), .d({g.ins[3]}), .cin({g.ins[4]}), "
                         f".s({g.outs[0]}), .carry({g.outs[1]}), .cout({g.outs[2]}));")
        elif g.kind == "RCA":
            ins = ", ".join(g.ins)
            lines.append(f"  RCA #(.W(ACC_W)) u_rca (.ops({{{ins}}}), .sum({g.outs[0]}));")
    return "\n".join(lines)


def emit_verilog(ppa: MacroPPA) -> str:
    d = ppa.design
    s = d.spec
    nl = tree_netlist(d)
    precisions = "_".join(str(p) for p in s.int_precisions)
    fp = "_".join(s.fp_precisions) if s.fp_precisions else "none"
    header = f"""\
    // ------------------------------------------------------------------
    // SynDCIM generated macro  —  {d.name()}
    // spec: H={s.h} W={s.w} MCR={s.mcr} INT={precisions} FP={fp}
    //       f_mac={s.f_mac_hz / 1e6:.0f}MHz @ {s.vdd:.2f}V
    // ppa : fmax={ppa.fmax_hz / 1e6:.0f}MHz area={ppa.area_um2 / 1e6:.4f}mm2
    //       latency={ppa.latency_cycles}cyc  TOPS(1b)={ppa.tops_1b:.2f}
    // audit:
    """
    audit = "\n".join(f"    //   - {a}" for a in d.audit) or "    //   (default)"
    body = f"""
    module dcim_macro #(
      parameter H = {s.h}, W = {s.w}, MCR = {s.mcr},
      parameter IB_MAX = {s.max_input_bits}, ACC_W = {ppa.csa_report.acc_width}
    ) (
      input  wire                clk, rst_n,
      input  wire [H-1:0]        in_bit,        // bit-serial activations
      input  wire [7:0]          in_mode,       // precision mode select
      input  wire                wl_we,         // weight-update strobe
      input  wire [$clog2(H*MCR)-1:0] wl_addr,
      input  wire [W-1:0]        bl_wdata,
      output wire [W*(ACC_W+IB_MAX)-1:0] macc_out,
      output wire                out_valid
    );

      // ---- memory array: {s.h}x{s.w} x MCR={s.mcr} {d.memcell.value} cells
      CELL_{d.memcell.value} u_array [H*MCR-1:0][W-1:0] (/* SDP-placed */);

      // ---- bitwise multiplier + multiplexer: {d.multmux.value}
      MULTMUX_{d.multmux.value.upper()} u_mult [H-1:0][W-1:0] (
        .in_bit(in_bit), .sel(/*mcr bank*/), .w(/*cell*/), .p(/*product*/));

      // ---- synthesized adder tree ({d.csa.name()}): one per column
      //      {len(nl.gates)} cells/column, {ppa.csa_report.stages} stages,
      //      retimed={d.csa.retimed}, reordered={d.csa.reorder}, split={d.csa.split}
{_tree_instances(nl)}

      // ---- shift & adder (bit-serial accumulation over IB_MAX cycles)
      always @(posedge clk) begin : shift_adder
        if (!rst_n) acc <= '0;
        else acc <= {{acc[ACC_W+IB_MAX-2:0], 1'b0}} + tree_sum; // shift-add
      end

      // ---- output fusion unit: {max(1, d.ofu_pipe_stages)} pipe stage(s),
      //      fuses column groups low->high precision
      OFU #(.W(W), .STAGES({d.ofu_pipe_stages})) u_ofu (
        .sa_out(acc), .mode(in_mode), .fused(macc_out), .valid(out_valid));

      // ---- FP/INT alignment unit ({fp})
      ALIGN #(.W(W)) u_align (.fp_in(/*...*/), .aligned(/*...*/));

    endmodule
    """
    return textwrap.dedent(header) + audit + "\n" + textwrap.dedent(body)
