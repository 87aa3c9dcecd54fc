"""The entry, `cli/video_nx.py: interpolate_padded` (pad, copies in and
out, unpad): a call's host-clock ms less the device time launched inside
its `prepare` and `decode_one` spans (mean over the traced calls)."""


def read(ctx):
    v = ctx.view
    pairs = v.spans.get("pair", [])
    if len(pairs) != len(ctx.host_s):
        return None
    stages = [iv for n in ("prepare", "decode_one") for iv in v.spans.get(n, [])]
    out = []
    for (ps, pe), host in zip(pairs, ctx.host_s):
        mine = [(s, e) for s, e in stages if ps <= s and e <= pe]
        dev = sum(a.dur for a in v.device
                  if a.launch is not None and any(s <= a.launch <= e for s, e in mine))
        out.append(host - dev)
    return 1e3 * sum(out) / len(out)
