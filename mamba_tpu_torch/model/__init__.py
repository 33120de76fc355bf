"""Model DSL, graph compiler and MCMC engine."""
