"""Cross-validation split policies (experiment constants).

The port's own copy of ``maxstyle_tpu/data/splits.py``, with sklearn's
``train_test_split`` replaced by :func:`train_test_split`, which draws the
same permutation and cuts it the same way, so every split names the same
patients as the JAX package's.

The patient-ID tables below are the published experimental protocol of the
reference (dataset_loader/ACDC_few_shot_cv_settings.py:10-215 — itself taken
from "Semi-Supervised and Task-Driven Data Augmentation", arXiv:1902.05396 —
and prostate_Decathlon_dataset.get_pid_list:166-213). They are data, not
code: reproducing them verbatim is required for benchmark comparability.
"""

from __future__ import annotations

import math
import numbers
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


def _check_size(name: str, size, n: int) -> None:
    if size is None:
        return
    if isinstance(size, numbers.Integral) and not 0 < size < n:
        raise ValueError(f"{name}={size} should be either positive and smaller than the "
                         f"number of samples {n} or a float in the (0, 1) range")
    if isinstance(size, numbers.Real) and not isinstance(size, numbers.Integral) \
            and not 0 < size < 1:
        raise ValueError(f"{name}={size} should be a float in the (0, 1) range")


def train_test_split(x: Sequence, *, test_size=None, train_size=None,
                     random_state: Optional[int] = None) -> Tuple[List, List]:
    """(train, test) lists of ``x``, as sklearn's
    ``train_test_split(x, test_size=..., train_size=..., random_state=...)``
    returns them: ``perm = RandomState(random_state).permutation(n)``; a
    float test size takes ceil(test_size * n) items, a float train size
    floor(train_size * n), an integer size that many; a size not given is
    the complement of the other (a test size of 0.25 when neither is);
    test = perm[:n_test], train = perm[n_test:n_test + n_train]."""
    n = len(x)
    if test_size is None and train_size is None:
        test_size = 0.25
    _check_size("test_size", test_size, n)
    _check_size("train_size", train_size, n)
    n_test = (math.ceil(test_size * n) if isinstance(test_size, float) else test_size)
    n_train = (math.floor(train_size * n) if isinstance(train_size, float) else train_size)
    if train_size is None:
        n_train = n - n_test
    elif test_size is None:
        n_test = n - n_train
    if n_train + n_test > n:
        raise ValueError(f"the sum of train_size and test_size = {n_train + n_test} "
                         f"should be smaller than the number of samples {n}")
    if n_train == 0:
        raise ValueError(f"with n_samples={n}, test_size={test_size} and "
                         f"train_size={train_size}, the resulting train set will be empty")
    perm = np.random.RandomState(random_state).permutation(n)
    return ([x[i] for i in perm[n_test:n_test + n_train]], [x[i] for i in perm[:n_test]])


ACDC_TEST_PATIENTS: List[str] = [
    "007", "008", "009", "010", "027", "028", "029", "030",
    "047", "048", "049", "050", "067", "068", "069", "070",
    "087", "088", "089", "090"]

_ACDC_STANDARD_TRAIN = [
    "001", "002", "003", "004", "006", "011", "012", "013", "014", "015",
    "016", "017", "018", "019", "021", "022", "024", "025", "026", "031",
    "032", "033", "034", "035", "036", "038", "039", "040", "041", "043",
    "044", "045", "051", "052", "053", "054", "055", "056", "057", "058",
    "059", "060", "061", "062", "063", "064", "065", "071", "072", "073",
    "074", "075", "076", "077", "079", "080", "081", "083", "084", "085",
    "086", "091", "092", "093", "094", "095", "096", "098", "099", "100"]

_ACDC_STANDARD_VAL = ["005", "020", "023", "037", "042", "046", "066", "078",
                      "082", "097"]

_ACDC_UNLABELLED = [
    "016", "017", "018", "019", "020", "036", "037", "038", "039", "040",
    "056", "057", "058", "059", "060", "076", "077", "078", "079", "080",
    "096", "097", "098", "099", "100"]

_ACDC_FRACTION_POOL = [
    "001", "002", "003", "004", "005", "006", "012", "013",
    "021", "022", "023", "024", "025", "026", "032", "033",
    "041", "042", "043", "044", "045", "046", "052", "053",
    "061", "062", "063", "064", "065", "066", "072", "073",
    "081", "082", "083", "084", "085", "086", "092", "093"]

_ACDC_FEWSHOT_VAL_BASE = ["011", "071"]
_ACDC_FEWSHOT_VAL_EXTRA = {
    0: ["062", "095", "082"], 1: ["002", "022", "095"],
    2: ["002", "062", "095"], 3: ["022", "062", "095"],
    4: ["022", "062", "082"]}
_ACDC_ONE_SHOT = {0: ["002"], 1: ["042"], 2: ["022"], 3: ["062"], 4: ["095"]}
_ACDC_ONE_SHOT_VAL_EXTRA = {
    0: ["042", "022", "062", "095"], 1: ["002", "022", "062", "095"],
    2: ["002", "042", "062", "095"], 3: ["002", "042", "022", "095"],
    4: ["002", "042", "022", "062"]}
_ACDC_THREE_SHOT = {
    0: ["002", "022", "042"], 1: ["042", "062", "082"],
    2: ["022", "042", "082"], 3: ["002", "042", "082"],
    4: ["002", "042", "095"]}

PROSTATE_TEST_PATIENTS = ["patient_17", "patient_7", "patient_12",
                          "patient_22", "patient_0", "patient_24", "patient_5"]


def acdc_split(identifier: str, cval: int) -> Dict[str, List[str]]:
    """ACDC split policy: 'standard' 70/10/20, 'one_shot'/'three_shot'
    (+'_upperbound'), or a numeric identifier ('10' -> 10 labelled
    patients drawn with train_test_split(random_state=cval) — identical
    draws to the reference)."""
    assert 0 <= cval < 5, f"five-fold cv only, got {cval}"
    if identifier == "standard":
        return {"name": f"standard_cv_{cval}", "train": list(_ACDC_STANDARD_TRAIN),
                "validate": list(_ACDC_STANDARD_VAL), "test": list(ACDC_TEST_PATIENTS),
                "unlabelled": [], "test+unlabelled": list(ACDC_TEST_PATIENTS)}

    validate = list(_ACDC_FEWSHOT_VAL_BASE) + list(_ACDC_FEWSHOT_VAL_EXTRA[cval])

    if "shot" in identifier:
        base = identifier.replace("_upperbound", "")
        if base == "one_shot":
            train = list(_ACDC_ONE_SHOT[cval])
            for sid in _ACDC_ONE_SHOT_VAL_EXTRA[cval]:
                if sid not in validate:
                    validate.append(sid)
        elif base == "three_shot":
            train = list(_ACDC_THREE_SHOT[cval])
        elif base == "25_shot":
            train, _ = train_test_split(list(_ACDC_FRACTION_POOL), train_size=25,
                                        random_state=cval)
        else:
            raise NotImplementedError(identifier)
        if identifier.endswith("_upperbound"):
            train = list(train) + list(_ACDC_UNLABELLED)
    else:
        frac = float(identifier)
        pool = list(_ACDC_FRACTION_POOL)
        if 0 < frac < 1:
            train, _ = train_test_split(pool, train_size=frac, random_state=cval)
        elif frac >= 1:
            n = int(frac)
            if n < len(pool):
                train, _ = train_test_split(pool, train_size=n, random_state=cval)
            elif n == len(pool):
                train = pool
            else:
                raise NotImplementedError(identifier)
        else:
            raise NotImplementedError(identifier)

    return {"name": f"{identifier}_cv_{cval}", "train": list(train),
            "validate": validate, "test": list(ACDC_TEST_PATIENTS),
            "unlabelled": list(_ACDC_UNLABELLED),
            "test+unlabelled": list(ACDC_TEST_PATIENTS) + list(_ACDC_UNLABELLED)}


def ukbb_split(identifier: str, cval: int) -> Dict[str, List[str]]:
    """UKBB policy (ACDC_few_shot_cv_settings.get_UKBB_split_policy:162-210):
    500 subjects '001'..'500', 70/10/20 split, labelled pool = first 150
    train subjects permuted with RandomState(cval)."""
    ids = np.arange(1, 501)
    train = ids[:350]
    unlabelled = [f"{i:03d}" for i in train[150:]]
    validate = [f"{i:03d}" for i in ids[350:400]]
    test = [f"{i:03d}" for i in ids[400:]]
    pool = train[:150]
    perm = np.random.RandomState(cval).permutation(len(pool))
    n = {"one_shot": 1, "three_shot": 3, "five_shot": 5, "15_shot": 15,
         "full": len(pool)}.get(identifier)
    if n is None:
        raise NotImplementedError(identifier)
    chosen = [f"{i:03d}" for i in perm[:n]]
    return {"name": f"{identifier}_cv_{cval}", "train": chosen,
            "validate": validate, "test": test, "unlabelled": unlabelled}


def prostate_split(all_patient_ids: Sequence[str], identifier: str,
                   cval: int) -> Dict[str, List[str]]:
    """Medical-Decathlon prostate split: fixed 7-patient test set, 90/10
    train/val via train_test_split(random_state=cval), then the labelled
    subset selection (prostate_Decathlon_dataset.get_pid_list:166-213)."""
    test_ids = [p for p in PROSTATE_TEST_PATIENTS if p in all_patient_ids]
    train_val = sorted(set(all_patient_ids) - set(test_ids))
    train_ids, val_ids = train_test_split(train_val, test_size=0.1,
                                          random_state=cval)
    half = len(train_val) // 2
    labelled = train_ids[:half]
    unlabelled = train_ids[half:]
    if identifier == "all":
        chosen, unlabelled = list(train_ids), []
    elif identifier == "full":
        chosen = labelled
    elif identifier == "three_shot":
        chosen, _ = train_test_split(labelled, train_size=3, random_state=cval)
    elif identifier == "three_shot_upperbound":
        chosen, _ = train_test_split(labelled, train_size=3, random_state=cval)
        chosen = list(chosen) + list(unlabelled)
        unlabelled = []
    else:
        try:
            frac = float(identifier)
        except ValueError:
            chosen = labelled
        else:
            if 0 < frac < 1:
                chosen, _ = train_test_split(labelled, train_size=frac,
                                             random_state=cval)
            elif frac > 1 and int(frac) < len(labelled):
                chosen, _ = train_test_split(labelled, train_size=int(frac),
                                             random_state=cval)
            else:
                chosen = labelled
    return {"name": f"{identifier}_cv_{cval}", "train": list(chosen),
            "validate": list(val_ids), "test": list(test_ids),
            "unlabelled": list(unlabelled),
            "test+unlabelled": list(test_ids) + list(unlabelled)}
