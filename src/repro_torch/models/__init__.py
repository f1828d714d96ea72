"""The decoder language model, every family of the reference: config,
layers, attention, the MoE and SSM mixers, and the model with its dense
decode caches."""
