"""GOOD: the sanctioned delta-COW write idiom — thread the cache through
``ensure_writable`` before any ``write_kv``, once per token for all
layers (the engine's ``_decode_step``)."""

from repro_torch.serving import kv_cache as kvc


def token_write(cfg, cache, ks, vs, mask):
    cache, bid, pos = kvc.ensure_writable(cfg, cache, mask)
    for layer in range(cfg.n_layers):
        cache = kvc.write_kv(cfg, cache, bid, pos, layer, ks[layer], vs[layer], mask)
    return kvc.advance(cache, mask)


def fork_then_free(cache, ancestors, mask):
    cache = kvc.fork(cache, ancestors)
    cache = kvc.free(cache, mask)
    return kvc.compact(cache)
