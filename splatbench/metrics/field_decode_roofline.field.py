"""Feature decoder: the share of its bound (`splatbench/field_bounds.py`
`decode_bound`: three products of 2 P' C_in C_out operations and the
resize over the FP32 rate, TF32 off; its reads and writes over the HBM
rate) that the port's spans `tgr.field.decode` and `tgr.field.decode.bwd`
reach: the bound over their device ms a step, median over the traced
steps. The channels are the span's own counts (`in_channels`,
`out_channels`), the sizes the configuration's frame and teacher map."""

import statistics

from splatbench import field_bounds, spans


def read(ctx):
  recs = spans.records()
  if recs is None:
    return None
  fwd = [r for r in recs if r["name"] == "tgr.field.decode"]
  if not fwd or "in_channels" not in fwd[0]["counts"]:
    return None
  cfg = ctx.entry.cfg
  w, h = cfg["image_size"]
  tw, th = cfg["field"]["teacher_size"]
  c = fwd[0]["counts"]
  bound = field_bounds.decode_bound((h, w), (th, tw), c["in_channels"],
                                    c["out_channels"])["ms"]
  ms = spans.per_frame(recs, ["field.decode", "field.decode.bwd"],
                       lambda r: r["device_ms"])
  shares = [100.0 * bound / v for v in ms.values() if v > 0]
  return statistics.median(shares) if shares else None
