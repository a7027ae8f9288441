"""Terminal rendering: ANSI frames (`ansi`), pooled frames for grids
larger than the window (`downsample`), raw-mode terminal (`terminal`)."""
