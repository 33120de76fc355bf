"""The program's side of each configuration, one module per configuration
(``<config>.py``): ``build(config, data, likelihood)`` returns the port's
model for the benchmark's data as ``(model, inputs, inits, module)``,
``module`` being where the traffic's Gibbs functions are found.  Only the
public ``build`` of the port's model modules is called.
"""
