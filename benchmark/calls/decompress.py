"""A call of one file: tbz_torch.decompress(payload), with the defaults
but for the traffic's keyword arguments."""


def setup(device, kwargs: dict):
    import tbz_torch
    kw = dict(kwargs)
    if device is not None:
        kw["device"] = device

    def call(payloads: list) -> list:
        (payload,) = payloads
        return [tbz_torch.decompress(payload, **kw)]

    return call
