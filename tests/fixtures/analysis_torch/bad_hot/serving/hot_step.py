"""Known-bad serving step for the hot-path lint's fixtures: one violation
per rule and per host-sync form, all of which MUST be flagged."""
import time

import torch

TABLE = torch.zeros(3).cpu()           # module level: no step runs it


def step(logits, mask):
    a = logits.argmax(-1).item()       # host-sync: .item()
    b = logits.argmax(-1).tolist()     # host-sync: .tolist()
    c = logits.cpu()                   # host-sync: .cpu()
    d = c.numpy()                      # host-sync: .numpy()
    e = logits.to("cpu")               # host-sync: .to("cpu")
    torch.cuda.synchronize()           # host-sync: synchronize
    if mask.any():                     # host-sync: if on a reduction
        a += 1
    while not torch.isfinite(logits).all():   # host-sync: while
        break
    n = int(mask.sum())                # host-sync: int() of a reduction
    f = bool(torch.equal(a, b))        # host-sync: bool() of torch.*
    return a, b, d, e, n, f


def stamp():
    return time.time()                 # wall-clock in a serving path


def bad_default(xs=[]):                # mutable-default
    xs.append(time.monotonic())        # monotonic: fine
    return xs
