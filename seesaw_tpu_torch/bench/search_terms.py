"""Category name -> natural query string cleanup, per dataset.

The port's own copy of `seesaw_tpu/bench/search_terms.py`: the same
mappings as the reference (`seesaw/dataset_search_terms.py:29-62`) — these
are benchmark protocol data, needed for score comparability.
"""
from __future__ import annotations


def _clean_space(x: str) -> str:
    return " ".join(x.strip().split())


def clean_objectnet_name(name: str) -> str:
    # "bills (money)" -> "money bills"; "coffee/french press" -> "coffee or french press"
    parts = name.split("(")
    if len(parts) == 2:
        noun, adj = parts
        adj = adj.replace(")", " ")
        name = " ".join([adj, noun])
    return _clean_space(name.replace("/", " or "))


def clean_lvis_name(name: str) -> str:
    return _clean_space(name.replace("_", " ").replace("(", " ").replace(")", " "))


def clean_dota_name(name: str) -> str:
    return name.replace("-", " ")


_clean_function = {
    "objectnet": clean_objectnet_name,
    "lvis": clean_lvis_name,
    "dota": clean_dota_name,
    "lvispatch": clean_lvis_name,
}

_special_cases = {
    "bdd": {
        "motor": "motorcycle",
        "rider": "bike rider",
        "gas stations scene": "gas station",
        "trailer": "trailer hitched to a car",
        "highway scene": "highway",
        "parking lot scene": "parking lot",
        "city street scene": "city street",
        "residential scene": "residential street",
        "tunnel scene": "tunnel",
        "overcast weather": "overcast sky",
        "partly cloudy weather": "partly cloudy sky",
        "clear weather": "clear skies",
        "foggy weather": "foggy weather",
        "wheelchair": "wheelchair",
    },
    "coco": {"mouse": "computer mouse"},
}


def category2query(dataset: str, cat: str) -> str:
    if cat in _special_cases.get(dataset, {}):
        return _special_cases[dataset][cat]
    return _clean_function.get(dataset, lambda x: x)(cat)
