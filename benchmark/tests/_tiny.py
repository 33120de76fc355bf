"""Small sizes of the cells for the CPU, in float32 as on the card: the
GLMM at 64 groups, rats' NUTS trees cut at depth 6 (the eager tree is what
costs on the CPU).  The chains are the cells' 1024, as many as
``score_z`` and ``stein_z`` need to read near 0 in a sound run and far
above their limits under a planted fault, and the warm-up as long as the
chains need to reach the posterior."""

GLMM = {"config": {"G": 64},
        "traffic": {"chains": 1024, "burnin": 100, "calibration_iters": 3,
                    "check_chain_block": 256, "profile_iters": 2,
                    "warm_start": {"steps": 100, "nmc": 4,
                                   "likelihood": "generic"}}}
RATS = {"traffic": {"chains": 1024, "burnin": 150, "calibration_iters": 2,
                    "profile_iters": 2,
                    "samplers": [
                        {"sampler": "NUTS",
                         "params": ["alpha", "beta", "mu_alpha", "mu_beta"],
                         "args": {"mass_window": 100, "max_depth": 6}},
                        {"sampler": "Gibbs",
                         "params": ["s2_c", "s2_alpha", "s2_beta"],
                         "fn": "var_gibbs"}]}}
TINY = {"rats-nuts": RATS, "glmm10k-chees": GLMM,
        "glmm10k-chees-generic": GLMM}


def with_dtype(overrides: dict, dtype: str) -> dict:
    return {"config": {**overrides.get("config", {}), "dtype": dtype},
            "traffic": overrides["traffic"]}
