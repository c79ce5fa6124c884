"""Scene contraction (port of the identity contraction of
hyperreel_tpu/ops/contract.py). The other contractions raise."""

from dataclasses import dataclass


@dataclass(frozen=True)
class IdentityContract:
    name: str = "identity"
    contract_samples: bool = False


def get_contract(cfg):
    if cfg is None or cfg.get("type", "identity") == "identity":
        return IdentityContract(
            contract_samples=bool((cfg or {}).get("contract_samples", False)))
    raise NotImplementedError(
        f"contraction {cfg['type']!r} is not ported yet "
        "(ROADMAP.md: K5/K6 and the other net families)")
