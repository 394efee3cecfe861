"""Plain numpy references for the layers the window drives. They import
nothing of the program and take nothing it made but the inputs of the
calls they recompute (see PERF.md, "How correct is decided")."""
