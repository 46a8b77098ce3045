"""A cell at the smoke size the CPU tests drive it at, found from the
cell's own names: the configuration, the traffic and the limits.

- Configuration: a kind that builds the port's model (`port_config`) runs
  the port's smoke model of the configuration's family, its leaves each
  drawn at the configuration's scale for that path, its vocabulary the
  smoke model's; every other kind runs
  on `fixtures/smoke.json`'s small tree of seeded vectors.  Either way the
  context is smoke.json's (N = 256).
- Traffic: the cell's traffic file, with `fixtures/smoke_traffic/<traffic>
  .json`'s keys in place where that file exists (a training batch's
  shape).
- Limits: `fixtures/smoke_limits/<cell>.json`, set as `limits/<cell>.json`
  are, from the program's readings on ten seeds (the lower) and each
  control's on three (the upper), between them.
"""
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
BENCH = HERE.parent
FIXTURES = HERE / "fixtures"
sys.path.insert(0, str(BENCH.parent / "src"))
sys.path.insert(0, str(BENCH))

import harness  # noqa: E402

SMOKE = harness.load_json(FIXTURES / "smoke.json")


def kind_of(cell: dict):
    return harness.kind(harness.load_json(BENCH / "traffic"
                                          / f"{cell['traffic']}.json"))


def config(cell: dict) -> dict:
    kind = kind_of(cell)
    if not hasattr(kind, "port_config"):
        return SMOKE
    from repro_torch import models

    cfg = harness.load_json(BENCH / "configs" / f"{cell['config']}.json")
    small = dict(cfg, smoke=True, ckks=SMOKE["ckks"])
    port = kind.port_config(small)
    small["vocab_size"] = port.vocab
    tree = models.build_model(port, device="cpu").init_abstract()
    scale = {lf["path"]: lf for lf in cfg["leaves"]}
    small["leaves"] = [{"path": p, "shape": list(s),
                        "mean": scale[p]["mean"], "std": scale[p]["std"]}
                       for p, s in kind.tree_shapes(tree)]
    return small


def traffic(name: str) -> dict:
    out = harness.load_json(BENCH / "traffic" / f"{name}.json")
    over = FIXTURES / "smoke_traffic" / f"{name}.json"
    if over.is_file():
        out.update(harness.load_json(over))
    return out


def limits(cell_name: str) -> dict:
    return harness.load_json(FIXTURES / "smoke_limits" / f"{cell_name}.json")
