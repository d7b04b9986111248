"""A user with many problems of one structure: one
`cuclarabel_torch.BatchSolver` built at the traffic's batch width and
settings, then for each group of the window fresh data through
`update_data` and `solve()`, which returns host answers."""

from portbench import generators

# the configuration's cone kinds, as the port names their types
PORT_CONES = {"zero": "ZeroConeT", "nonneg": "NonnegativeConeT",
              "soc": "SecondOrderConeT", "psd": "PSDTriangleConeT",
              "exp": "ExponentialConeT", "pow": "PowerConeT",
              "genpow": "GenPowerConeT"}


def port_cones(ct, cones):
    """The port's cone objects of (kind, *parameters) tuples."""
    return [getattr(ct, PORT_CONES[kind])(*params)
            for kind, *params in cones]


class Driver:
    def __init__(self, cell, seed, device):
        import cuclarabel_torch as ct
        self.cell, self.seed = cell, seed
        self.cfg, self.gen = cell.config, cell.generator
        self.struct = self.gen.structure(self.cfg)
        self.batch = int(cell.traffic["batch"])
        warm = self.gen.batch(self.cfg, self.struct,
                              generators.rng(seed, generators.WARMUP, 0),
                              self.batch)
        self.solver = ct.BatchSolver(
            self.struct["P"], warm["q"], self.struct["A"], warm["b"],
            port_cones(ct, self.struct["cones"]), device=device,
            **cell.traffic.get("settings", {}))
        self.solver.solve()

    def data(self, k):
        return self.gen.batch(self.cfg, self.struct,
                              generators.rng(self.seed, generators.WINDOW,
                                             k), self.batch)

    def serve(self, data):
        self.solver.update_data(**data)
        return self.solver.solve()

    def close(self):
        del self.solver
