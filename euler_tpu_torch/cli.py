"""Command-line interface (`euler_tpu/cli.py`), the same surface:

    python -m euler_tpu_torch [--rainbow] <scenario>

plus --size YxX, --fps, --frames (headless), preset:<name>, and the
checkpoint trio --checkpoint / --checkpoint-every / --load.

Keys (main.c:961-980): p pause, f single frame, r re-colour, q quit.
Fixed-rate pacing (main.c:1034-1038, misc/time.c:17-31).

The configuration is the one the JAX CLI's `_build` makes: by default
and with --pallas the slot layout, the converged MG-PCG solve (with the
fused substep where it fits; at sizes whose MG levels do not halve
evenly, such as 1080x1920, 720x1280 or 1200x1200, the unfused grid stage
K7 and P3) from 512² up and the reference's Jacobi budget below; with --no-pallas the reference's own configuration, the
global marker layout with the Jacobi budget (the JAX CLI's non-Pallas
path).  The port takes its hand-written kernels on every route (G1, G2
and K7 with K8 or P1 for --no-pallas), so --cpu means "the same
configuration on the CPU" (each kernel wrapper then takes its plain
version), not the JAX CLI's XLA / global-layout path.  --sherlock
traps NaNs: a frame whose output state holds one raises
FloatingPointError (`utils.diagnostics.enable_fpmath_asserts`).

A render thread writes the latest frame to the terminal, so the step
loop never waits on terminal I/O.
"""

from __future__ import annotations

import argparse
import queue
import sys
import threading
import time


def parse_args(argv):
    ap = argparse.ArgumentParser(
        prog="euler_tpu_torch",
        description="Eulerian liquid simulator on an NVIDIA GPU (the "
        "PyTorch/CUDA port of euler_tpu)")
    ap.add_argument("scenario", nargs="?", default=None,
                    help="scenario file, or preset:<name> (dam_break, "
                    "block_obstacles)")
    ap.add_argument("--rainbow", action="store_true")
    ap.add_argument("--size", default=None,
                    help="grid size YxX (default 40x100)")
    ap.add_argument("--frames", type=int, default=0,
                    help="run N frames headless and exit (no terminal UI)")
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (the kernels' plain versions), "
                    "same configuration")
    ap.add_argument(
        "--pallas", action=argparse.BooleanOptionalAction, default=None,
        help="the slot marker layout (the default); --no-pallas: the "
        "global marker layout with the reference's Jacobi budget, the JAX "
        "CLI's non-Pallas configuration (both run the hand-written "
        "kernels)")
    ap.add_argument(
        "--converged", action=argparse.BooleanOptionalAction, default=None,
        help="converged pressure solve (Galerkin MG-PCG, tol_rel 1e-4, "
        "warm start) and the fused substep.  Default: on for grids >= "
        "512², off (the reference's Jacobi budget) below")
    ap.add_argument("--sherlock", action="store_true",
                    help="trap NaNs: raise FloatingPointError when a "
                    "frame's output holds one")
    ap.add_argument("--load", default=None, metavar="CKPT",
                    help="resume from a checkpoint .npz (scenario ignored)")
    ap.add_argument("--checkpoint", default=None, metavar="PATH",
                    help="checkpoint file to write (with --checkpoint-every)")
    ap.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                    help="save a checkpoint every N frames (headless runs; "
                    "saves happen on a background thread)")
    args = ap.parse_args(argv)
    if args.checkpoint_every and not args.checkpoint:
        ap.error("--checkpoint-every requires --checkpoint PATH")
    return args


def build_config(args):
    """The SimConfig the JAX CLI's `_build` makes with --pallas (the
    default here, where --cpu does not change the configuration) or with
    --no-pallas."""
    from euler_tpu_torch.config import SimConfig, SolverConfig

    use_pallas = args.pallas is not False
    ny, nx = 40, 100
    if args.size:
        ny, nx = (int(t) for t in args.size.lower().split("x"))
    converged = args.converged
    if converged is None:
        converged = use_pallas and nx * ny >= 512 * 512
    solver = (
        SolverConfig(use_pallas=use_pallas, preconditioner="mg",
                     tol_rel=1e-4, fuse_projection=True, warm_start=True)
        if converged else SolverConfig(use_pallas=use_pallas))
    return SimConfig(nx=nx, ny=ny, rainbow=args.rainbow,
                     marker_layout="slots" if use_pallas else "global",
                     use_pallas_markers=use_pallas, solver=solver)


def _build(args):
    """(cfg, scn, state) from the arguments: a checkpoint, a preset or a
    scenario file, the tensors on the card (on the CPU with --cpu)."""
    device = "cpu" if args.cpu else "cuda"
    if args.load:
        from euler_tpu_torch.io.checkpoint import load

        return load(args.load, device=device)
    if args.scenario is None:
        print("usage: euler_tpu_torch [flags] <scenario> (or --load CKPT)",
              file=sys.stderr)
        sys.exit(1)
    cfg = build_config(args)
    if args.scenario.startswith("preset:"):
        from euler_tpu_torch.core import presets

        name = args.scenario.split(":", 1)[1]
        scn, state = getattr(presets, name)(cfg, device=device)
    else:
        from euler_tpu_torch.core.scenario import load_scenario

        try:
            scn, state = load_scenario(args.scenario, cfg, device=device)
        except OSError:
            print(f"Could not load {args.scenario}!", file=sys.stderr)
            sys.exit(1)
    return cfg, scn, state


def run_headless(args):
    from euler_tpu_torch.sim import step_frame

    cfg, scn, state = _build(args)

    # periodic checkpoints on a worker thread, so the step loop never
    # waits on disk; a frame's state is never written after the frame
    # (sim.step_frame gives fresh tensors), so handing it over is safe
    saver = None
    pending: "queue.Queue" = queue.Queue()
    if args.checkpoint:
        from euler_tpu_torch.io.checkpoint import save

        def save_loop():
            while True:
                item = pending.get()
                if item is None:
                    return
                save(args.checkpoint, cfg, scn, item)

        saver = threading.Thread(target=save_loop, daemon=True)
        saver.start()

    # a warm-up frame outside the timer (kernel builds, workspaces),
    # its result discarded so --frames N simulates exactly N frames; the
    # device is read once after it and once after the last frame
    warm = step_frame(cfg, scn, state)
    float(warm.u.sum())
    del warm
    t0 = time.perf_counter()
    for i in range(args.frames):
        state = step_frame(cfg, scn, state)
        if args.checkpoint_every and (i + 1) % args.checkpoint_every == 0:
            pending.put(state)
    float(state.u.sum())
    dt = time.perf_counter() - t0
    if saver is not None:
        pending.put(state)  # final snapshot
        pending.put(None)
        saver.join()
    dropped = int(state.dropped_markers)
    print(
        f"{args.frames} frames ({cfg.nx}x{cfg.ny}) in {dt:.3f}s "
        f"= {args.frames / dt:.1f} frames/s, "
        f"{cfg.nx * cfg.ny * cfg.max_substeps * args.frames / dt:.3g} "
        "cell-steps/s"
        + (f", {dropped} markers dropped (slot capacity)" if dropped else ""))


def run_interactive(args):
    from euler_tpu_torch.ops.color import colorize
    from euler_tpu_torch.render import terminal as term
    from euler_tpu_torch.render.ansi import draw_frame
    from euler_tpu_torch.render.downsample import draw_frame_downsampled
    from euler_tpu_torch.sim import step_frame

    cfg, scn, state = _build(args)

    window = {}

    def update_window_size(*_sig):
        rows, cols = term.get_window_size()
        window["rows"], window["cols"] = rows, cols
        term.clear_screen_now()

    update_window_size()
    term.set_window_size_handler(update_window_size)

    # the renderer takes the latest frame and drops stale ones
    frames: "queue.Queue[bytes]" = queue.Queue(maxsize=1)
    stop = threading.Event()

    def render_loop():
        while not stop.is_set():
            try:
                buf = frames.get(timeout=0.1)
            except queue.Empty:
                continue
            term._write(buf)

    rt = threading.Thread(target=render_loop, daemon=True)
    rt.start()

    term.enable_raw_mode()
    term.clear_screen_now()

    paused = False
    temp_unpause = 0
    frame_period = 1.0 / args.fps
    start = time.monotonic()
    try:
        while True:
            c = term.read_key()
            if c == "p":
                paused = not paused
            elif c == "f":
                temp_unpause += 1
            elif c == "r" and cfg.rainbow:
                state = colorize(cfg, scn, state)
            elif c == "q":
                term.clear_screen_now()
                break

            if not paused or temp_unpause > 0:
                state = step_frame(cfg, scn, state)
                if temp_unpause:
                    temp_unpause -= 1

            # pacing before the draw, as the reference orders it
            # (main.c:1034-1037), as wait_until does (misc/time.c:17-31):
            # sleep the rest of the period from the carried start, not at
            # all once >= 1 s has passed, and carry the clock after it
            now = time.monotonic()
            elapsed = now - start
            if elapsed < 1.0:
                wait = frame_period - elapsed
                if wait > 0:
                    time.sleep(wait)
                    now = time.monotonic()
            start = now

            # grids larger than the window: pooled on the device
            rows, cols = window["rows"], window["cols"]
            if cfg.ny - 2 > rows or cfg.nx - 2 > cols:
                buf = draw_frame_downsampled(cfg, scn, state, rows, cols)
            else:
                buf = draw_frame(cfg, scn, state, rows, cols)
            try:  # drop the stale frame if the renderer is behind
                frames.put_nowait(buf)
            except queue.Full:
                try:
                    frames.get_nowait()
                except queue.Empty:
                    pass
                frames.put_nowait(buf)
    finally:
        stop.set()
        rt.join(timeout=1.0)


def main(argv=None):
    args = parse_args(sys.argv[1:] if argv is None else argv)
    if args.sherlock:
        from euler_tpu_torch.utils.diagnostics import enable_fpmath_asserts

        enable_fpmath_asserts()
    if args.frames:
        run_headless(args)
    else:
        run_interactive(args)


if __name__ == "__main__":
    main()
