"""The in-sim mean-reverting spot-price walk (DESIGN.md §10), PyTorch port
of `repro.market.synthetic.walk_price_update`.

The price path of a process-market epoch depends only on the epoch's
starting price and the normal noise, never on the consensus state, so
`core/draws.py` runs the walk once per epoch (`epoch_walk_prices`) and
the tick reads row `t` of the path.  The expression keeps the JAX
package's operation order; evaluated eagerly it matches numpy float32,
while a jitted JAX walk may differ in the last bit (XLA fuses the
arithmetic), which is why the tests replay JAX's own price path.
"""
from __future__ import annotations

import torch


def walk_price_update(price: torch.Tensor, mean: torch.Tensor, vol,
                      normal: torch.Tensor) -> torch.Tensor:
    """One tick of the walk given the tick's standard-normal draws."""
    noise = normal * vol * mean
    price = price + 0.2 * (mean - price) + 0.15 * noise
    return torch.maximum(price, 0.1 * mean)


def epoch_walk_prices(price0: torch.Tensor, mean: torch.Tensor, vol,
                      normals: torch.Tensor) -> torch.Tensor:
    """The (T, S) price path of one epoch: row t is the price after tick
    t, chained from `price0` through `normals[t]`."""
    rows = []
    price = price0
    for t in range(normals.shape[0]):
        price = walk_price_update(price, mean, vol, normals[t])
        rows.append(price)
    return torch.stack(rows)
