"""Per-layer metrics, `metrics/<name>.py` each: `read(ctx)` takes the
traced stretch (`harness.Traced`) and returns the metric's value, or None
where the stretch holds nothing it reads (the harness then leaves the
metric out of the line)."""
