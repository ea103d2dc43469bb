"""The 85 ``fr_*`` functional-group fragment counters.

The reference's descriptastorus ``rdkit_2d`` 200-descriptor vector (cf.
reference ``chemprop/featurizers/molecule.py:53-99``) ends with RDKit's 85
fragment-count descriptors, each defined by a SMARTS pattern matched with
uniquified substructure search. This module provides the same 85 names in the
same (string-sorted) order, matched by the in-repo SMARTS engine
(:mod:`chemprop_tpu_torch.chem.smarts`).

The patterns are written from the functional-group definitions the RDKit
descriptors document (``rdkit.Chem.Fragments``); where RDKit's exact SMARTS
encodes subtle medicinal-chemistry exclusions (e.g. Topliss ketones,
non-ortho-H-bonded phenols) the pattern here is a documented approximation
of the named group. Counts are therefore chemically equivalent but not
guaranteed bit-identical to RDKit on exotic edge cases.
"""

from __future__ import annotations

import numpy as np

from chemprop_tpu_torch.chem.mol import Mol
from chemprop_tpu_torch.chem.smarts import count_matches

_NITRO = "[$([NX3](=O)=O),$([NX3+](=O)[O-])]"

# name -> SMARTS, in the exact (string-sorted) descriptastorus order
FRAGMENT_SMARTS: dict[str, str] = {
    "fr_Al_COO": "C-C(=O)[O;H1,-1]",
    "fr_Al_OH": "[C;!$(C=O)]-[OX2H1]",
    "fr_Al_OH_noTert": "[$([C;!$(C=O)]-[OX2H1]);!$(C(-[OX2H1])(-[#6])(-[#6])-[#6])]",
    "fr_ArN": "[NX3;!$(N=O);!$(N-C=O)]-c",
    "fr_Ar_COO": "c-C(=O)[O;H1,-1]",
    "fr_Ar_N": "n",
    "fr_Ar_NH": "c-[NX3;H1,H2]",
    "fr_Ar_OH": "c-[OX2H1]",
    "fr_COO": "[#6]C(=O)[O;H1,-1]",
    "fr_COO2": "[CX3](=O)[$([OX1-]),$([OX2H1])]",
    "fr_C_O": "[CX3]=[OX1]",
    "fr_C_O_noCOO": "[CX3;!$([CX3][OX2H1]);!$([CX3][OX1-])]=[OX1]",
    "fr_C_S": "[CX3]=[SX1]",
    "fr_HOCCN": "[OX2H1][CX4][CX4][NX3]",
    "fr_Imine": "[NX2;!$(N-O)]=[CX3]",
    "fr_NH0": "[NH0,nH0]",
    "fr_NH1": "[NH1,nH1]",
    "fr_NH2": "[NH2,nH2]",
    "fr_N_O": "[NX3]-[OX2H1]",
    "fr_Ndealkylation1": "[NX3]-[CH3]",
    "fr_Ndealkylation2": "[NX3]-[CH2]-[#6]",
    "fr_Nhpyrrole": "[nH]",
    "fr_SH": "[SX2H1]",
    "fr_aldehyde": "[CX3H1](=O)[#6]",
    "fr_alkyl_carbamate": "[NX3]C(=O)[OX2][CX4]",
    "fr_alkyl_halide": "[CX4]-[F,Cl,Br,I]",
    "fr_allylic_oxid": "[CX4;!$(C-[O,N,S]);H1,H2,H3]-[CX3]=[CX3]",
    "fr_amide": "C(=O)-[NX3]",
    "fr_amidine": "C(=N)(-N)-[!#7]",
    "fr_aniline": "c-[NX3]",
    "fr_aryl_methyl": "a-[CH3]",
    "fr_azide": "[NX2]~[NX2+]~[NX1-,NX1]",
    "fr_azo": "[#6]-[NX2]=[NX2]-[#6]",
    "fr_barbitur": "C1C(=O)NC(=O)NC1=O",
    "fr_benzene": "c1ccccc1",
    "fr_benzodiazepine": "O=C1CN=Cc2ccccc2N1",
    "fr_bicyclic": "[R2][R2]",  # fused-ring bond (RDKit Fragments: Bicyclic)
    "fr_diazo": "[$([#6]=[NX2+]=[NX1-]),$([#6]-[NX2+]#[NX1])]",
    "fr_dihydropyridine": "N1C=CCC=C1",
    "fr_epoxide": "[OX2r3]1[#6r3][#6r3]1",
    "fr_ester": "[#6][CX3](=O)[OX2H0][#6]",
    "fr_ether": "[OD2]([#6])[#6]",
    "fr_furan": "c1ccoc1",
    "fr_guanido": "C(=N)(N)N",
    "fr_halogen": "[#9,#17,#35,#53]",
    "fr_hdrzine": "[NX3]-[NX3]",
    "fr_hdrzone": "[CX3]=[NX2]-[NX3]",
    "fr_imidazole": "c1cncn1",
    "fr_imide": "[CX3](=O)[NX3][CX3](=O)",
    "fr_isocyan": "[NX2]=[CX2]=[OX1]",
    "fr_isothiocyan": "[NX2]=[CX2]=[SX1]",
    "fr_ketone": "[#6][CX3](=O)[#6]",
    "fr_ketone_Topliss": "[$([CX3](=[OX1])([#6])[#6]);!$([CX3](=[OX1])[#6]=[#6])]",
    "fr_lactam": "N1C(=O)CC1",
    "fr_lactone": "[CX3;R](=[OX1])[OX2;R]",
    "fr_methoxy": "[OX2](-[#6])-[CH3]",
    "fr_morpholine": "O1CCNCC1",
    "fr_nitrile": "[NX1]#[CX2]",
    "fr_nitro": _NITRO,
    "fr_nitro_arom": f"c-{_NITRO}",
    "fr_nitro_arom_nonortho": f"[$([c](:[cH]):[cH])]-{_NITRO}",
    "fr_nitroso": "[NX2]=[OX1]",
    "fr_oxazole": "c1ocnc1",
    "fr_oxime": "[CX3]=[NX2]-[OX2H1]",
    "fr_para_hydroxylation": "[$([cH]1[cH]cc(c[cH]1)~[$([#8,$([#8]~[#6;!$([#6]=[!#6])])])]),$([cH]1[cH]cc(c[cH]1)~[$([#7X3])]),$([cH]1[cH]cc(c[cH]1)~[$([#6]=[#6])])]",  # para-CH to O/N/vinyl (RDKit)
    "fr_phenol": "[OX2H1]-c1ccccc1",
    "fr_phenol_noOrthoHbond": (
        "[$([OX2H1]-c1ccccc1);"
        "!$([OX2H1]-c1ccccc1-[$([CX3]=[OX1]),$([#7]),$([OX2H1])])]"
    ),
    "fr_phos_acid": "[PX4](=[OX1])([$([OX2H1]),$([OX1-])])",
    "fr_phos_ester": "[PX4](=[OX1])[OX2][#6]",
    "fr_piperdine": "N1CCCCC1",
    "fr_piperzine": "N1CCNCC1",
    "fr_priamide": "[CX3](=[OX1])[NX3H2]",
    "fr_prisulfonamd": "[SX4](=[OX1])(=[OX1])[NX3H2]",
    "fr_pyridine": "c1ccncc1",
    "fr_quatN": "[NX4]",
    "fr_sulfide": "[SX2](-[#6])-[#6]",
    "fr_sulfonamd": "[SX4](=[OX1])(=[OX1])[NX3]",
    "fr_sulfone": "[SX4](=[OX1])(=[OX1])([#6])[#6]",
    "fr_term_acetylene": "[CX2]#[CX2H1]",
    "fr_tetrazole": "c1nnnn1",
    "fr_thiazole": "c1scnc1",
    "fr_thiocyan": "[SX2]-[CX2]#[NX1]",
    "fr_thiophene": "c1ccsc1",
    "fr_unbrch_alkane": "[CR0;D2][CR0;D2][CR0;D2][CR0;D2]",
    "fr_urea": "[NX3][CX3](=[OX1])[NX3]",
}

FRAGMENT_NAMES: list[str] = list(FRAGMENT_SMARTS)
assert FRAGMENT_NAMES == sorted(FRAGMENT_NAMES), "fragment order must be string-sorted"
assert len(FRAGMENT_NAMES) == 85


def fragment_counts(mol: Mol) -> np.ndarray:
    """All 85 fragment counts in descriptor order."""
    return np.array(
        [count_matches(mol, smt) for smt in FRAGMENT_SMARTS.values()], dtype=np.float64
    )


def fragment_count(mol: Mol, name: str) -> int:
    return count_matches(mol, FRAGMENT_SMARTS[name])
