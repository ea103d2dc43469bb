"""Element data for the self-contained chemistry substrate.

The reference framework delegates all chemistry to RDKit (a C++ dependency);
this framework ships its own minimal periodic table so that SMILES parsing and
featurization (cf. reference ``chemprop/featurizers/atom.py``) work without any
external cheminformatics toolkit.

Atomic masses are IUPAC 2021 standard atomic weights (conventional values for
intervals), matching RDKit's values to the precision used by the featurizers
(the atom featurizer emits ``0.01 * mass``).
"""

from __future__ import annotations

# fmt: off
SYMBOLS: list[str] = [
    "*",
    "H", "He", "Li", "Be", "B", "C", "N", "O", "F", "Ne",
    "Na", "Mg", "Al", "Si", "P", "S", "Cl", "Ar", "K", "Ca",
    "Sc", "Ti", "V", "Cr", "Mn", "Fe", "Co", "Ni", "Cu", "Zn",
    "Ga", "Ge", "As", "Se", "Br", "Kr", "Rb", "Sr", "Y", "Zr",
    "Nb", "Mo", "Tc", "Ru", "Rh", "Pd", "Ag", "Cd", "In", "Sn",
    "Sb", "Te", "I", "Xe", "Cs", "Ba", "La", "Ce", "Pr", "Nd",
    "Pm", "Sm", "Eu", "Gd", "Tb", "Dy", "Ho", "Er", "Tm", "Yb",
    "Lu", "Hf", "Ta", "W", "Re", "Os", "Ir", "Pt", "Au", "Hg",
    "Tl", "Pb", "Bi", "Po", "At", "Rn", "Fr", "Ra", "Ac", "Th",
    "Pa", "U", "Np", "Pu", "Am", "Cm", "Bk", "Cf", "Es", "Fm",
    "Md", "No", "Lr", "Rf", "Db", "Sg", "Bh", "Hs", "Mt", "Ds",
    "Rg", "Cn", "Nh", "Fl", "Mc", "Lv", "Ts", "Og",
]

MASSES: list[float] = [
    0.0,
    1.008, 4.003, 6.941, 9.012, 10.811, 12.011, 14.007, 15.999, 18.998, 20.180,
    22.990, 24.305, 26.982, 28.086, 30.974, 32.067, 35.453, 39.948, 39.098, 40.078,
    44.956, 47.867, 50.942, 51.996, 54.938, 55.845, 58.933, 58.693, 63.546, 65.39,
    69.723, 72.61, 74.922, 78.96, 79.904, 83.80, 85.468, 87.62, 88.906, 91.224,
    92.906, 95.94, 98.0, 101.07, 102.906, 106.42, 107.868, 112.412, 114.818, 118.711,
    121.760, 127.60, 126.904, 131.29, 132.905, 137.328, 138.906, 140.116, 140.908, 144.24,
    145.0, 150.36, 151.964, 157.25, 158.925, 162.50, 164.930, 167.26, 168.934, 173.04,
    174.967, 178.49, 180.948, 183.84, 186.207, 190.23, 192.217, 195.078, 196.967, 200.59,
    204.383, 207.2, 208.980, 209.0, 210.0, 222.0, 223.0, 226.0, 227.0, 232.038,
    231.036, 238.029, 237.0, 244.0, 243.0, 247.0, 247.0, 251.0, 252.0, 257.0,
    258.0, 259.0, 262.0, 267.0, 268.0, 269.0, 270.0, 269.0, 278.0, 281.0,
    281.0, 285.0, 286.0, 289.0, 289.0, 293.0, 294.0, 294.0,
]
# fmt: on

ATOMIC_NUM: dict[str, int] = {s: i for i, s in enumerate(SYMBOLS)}

# Default valences (Daylight/RDKit style). Multiple entries = allowed valence
# states, lowest first; implicit H count uses the smallest valence >= current
# bond-order sum. -1 entry means "anything goes" (no implicit Hs ever added).
DEFAULT_VALENCES: dict[int, tuple[int, ...]] = {
    1: (1,),          # H
    2: (0,),          # He
    3: (1,),          # Li
    4: (2,),          # Be
    5: (3,),          # B
    6: (4,),          # C
    7: (3,),          # N
    8: (2,),          # O
    9: (1,),          # F
    10: (0,),         # Ne
    11: (1,),         # Na
    12: (2,),         # Mg
    13: (3,),         # Al  (RDKit: 3, also 6 in hypervalent contexts)
    14: (4,),         # Si
    15: (3, 5),       # P
    16: (2, 4, 6),    # S
    17: (1,),         # Cl
    18: (0,),         # Ar
    19: (1,),         # K
    20: (2,),         # Ca
    31: (3,),         # Ga
    32: (4,),         # Ge
    33: (3, 5),       # As
    34: (2, 4, 6),    # Se
    35: (1,),         # Br
    36: (0,),         # Kr
    37: (1,),         # Rb
    38: (2,),         # Sr
    52: (2, 4, 6),    # Te
    53: (1, 3, 5),    # I
    54: (0, 2),       # Xe
    55: (1,),         # Cs
    56: (2,),         # Ba
}

def n_outer_electrons(z: int) -> int:
    """Valence electron count for main-group elements (transition metals,
    lanthanides, and actinides return 0: they never receive implicit Hs nor
    participate in lone-pair perception here)."""
    if z <= 0:
        return 0
    if z <= 2:  # H, He
        return z
    for start, end in ((3, 10), (11, 18)):  # periods 2-3: col = z - start + 1 in 1..8
        if start <= z <= end:
            return z - start + 1
    for start, end in ((19, 36), (37, 54)):  # periods 4-5: 18 wide
        if start <= z <= end:
            col = z - start + 1
            if col <= 2:
                return col
            if col >= 13:
                return col - 10
            return 0
    for start, end in ((55, 86), (87, 118)):  # periods 6-7: 32 wide
        if start <= z <= end:
            col = z - start + 1
            if col <= 2:
                return col
            if col >= 27:  # Tl..Rn block (after 14 f + 10 d)
                return col - 24
            return 0
    return 0


# Organic subset: atoms that may be written bare (outside brackets) in SMILES.
ORGANIC_SUBSET = {"B", "C", "N", "O", "P", "S", "F", "Cl", "Br", "I", "*"}

# Elements that may be written lowercase (aromatic) in SMILES.
AROMATIC_SYMBOLS = {"b", "c", "n", "o", "p", "s", "se", "as", "te", "si"}
