"""One reader a metric, found by the metric's name: `read(run)` returns its
value from what the run measured, or None where the run holds nothing for
it to read (the harness then leaves the metric out). `run` holds setup_s,
steps, mpix, window_s, peak_bytes, and plain_steps and plain_s (the
window's untraced rounds), and with --trace 1 `trace` (the reduced
profile of the traced rounds, `htbench.trace`) and `reckon` (one step
profiled after the window, with the work of its views,
`htbench.reckon`)."""
