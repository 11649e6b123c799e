"""Statistical language identification model.

The reference embeds the ``lingua`` detector built over a hardcoded candidate
set {English, Danish, Swedish, Nynorsk, Bokmal} on every call
(``/root/reference/src/pipeline/filters/language_filter.rs:39-46``).  lingua's
proprietary n-gram tables cannot be shipped here, so this module provides the
framework's own statistical model with the same *interface* and candidate set:
a hashed character-trigram naive-Bayes classifier whose profiles are trained
from two built-in sources — frequency-ranked function-word lists
(Zipf-weighted) and per-language running prose
(:mod:`textblaster_tpu.models.langid_data`).  Decision agreement is measured
on a labeled out-of-sample corpus in ``tests/test_langid_agreement.py``.

The model is deliberately table-shaped for TPU execution: scoring is
``logprob_table[hash(trigram)] -> [n_langs]`` gathers summed per document —
on device this is a gather + segmented sum over the packed byte tensor (see
:mod:`textblaster_tpu.ops.langid_tpu`), on host the identical numpy
computation, so host and device decisions agree exactly.

Confidence semantics follow lingua's relative-confidence shape: softmax over
per-language total log-likelihoods, sharpening with document length.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

__all__ = [
    "LANGUAGES",
    "ISO_TO_NAME",
    "NAME_TO_ISO",
    "LangIdModel",
    "get_model",
]

# Candidate set and display names exactly as lingua's Display renders them
# (language_filter.rs:39-46, metadata asserted in language_filter.rs:203-218).
LANGUAGES: Tuple[str, ...] = ("English", "Danish", "Swedish", "Nynorsk", "Bokmal")
ISO_TO_NAME: Dict[str, str] = {
    "eng": "English",
    "dan": "Danish",
    "swe": "Swedish",
    "nno": "Nynorsk",
    "nob": "Bokmal",
}
NAME_TO_ISO: Dict[str, str] = {v: k for k, v in ISO_TO_NAME.items()}

TABLE_BITS = 16
TABLE_SIZE = 1 << TABLE_BITS

# Frequency-ranked word lists (approximate top-of-corpus orderings).  Rank r
# contributes Zipf weight 1/(r+1).  These are public-knowledge function-word
# inventories, not copied from any single source.
_WORDS: Dict[str, Sequence[str]] = {
    "English": (
        "the of and a to in is you that it he was for on are as with his they i".split()
        + "at be this have from or one had by word but not what all were we when".split()
        + "your can said there use an each which she do how their if will up other".split()
        + "about out many then them these so some her would make like him into time".split()
        + "has look two more write go see number no way could people my than first".split()
        + "water been call who oil its now find long down day did get come made may".split()
        + "part over new sound take only little work know place year live me back".split()
        + "give most very after thing our just name good sentence man think say great".split()
        + "where help through much before line right too mean old any same tell boy".split()
        + "follow came want show also around form three small set put end does".split()
    ),
    "Danish": (
        "og i at det er en den til af som på de med han der ikke et var jeg".split()
        + "men sig har om vi hun havde fra ham du kan nu over så skal ved kunne".split()
        + "eller hvad deres efter op under være dem også min alle noget meget her".split()
        + "hele andre blev hvor da sin mod selv ud se os kom mig når hvis hans".split()
        + "hende få vil end år mellem sige to både sådan dag gang denne siger".split()
        + "uden gennem lidt mand skulle vide tid tilbage først godt mere bliver".split()
        + "frem endnu går ind fordi ligger derfor siden får netop blandt mange".split()
        + "kærlighed hjælp måde allerede ingen intet tre fik stadig lige jo nej".split()
        + "altid bare måske kroner arbejde hvordan verden børn gerne danske dansk".split()
        + "københavn øjne hjem huset aldrig næsten igen store mindre penge".split()
        + "vej vejret nej sejr lejlighed øje høj hedder gade uge sprog måned".split()
        + "sætning svært lærer tænke længe færdig træffe hjælpe søndag onsdag".split()
    ),
    "Swedish": (
        "och i att det som en på är av för med den till han var inte om de ett".split()
        + "men sig jag hade vi hon så från vid kan nu över skall ska kunde eller".split()
        + "vad deras efter upp under vara dem också min alla något mycket här hela".split()
        + "andra blev där då sin mot själv ut se oss kom mig när om hans henne få".split()
        + "vill än år mellan säga två både sådan dag gång denna säger utan genom".split()
        + "lite man skulle veta tid tillbaka först bra mer blir fram ännu går in".split()
        + "eftersom ligger därför sedan får just bland många kärlek hjälp sätt".split()
        + "redan ingen inget tre fick fortfarande precis ju nej alltid bara kanske".split()
        + "kronor arbete hur världen barn gärna svenska svensk stockholm ögon hem".split()
        + "huset aldrig nästan igen stora mindre pengar något människor".split()
    ),
    "Nynorsk": (
        "og i å det er ein den til av som på dei med han der ikkje eit var eg".split()
        + "men seg har om vi ho hadde frå han du kan no over så skal ved kunne".split()
        + "eller kva deira etter opp under vere dei også min alle noko mykje her".split()
        + "heile andre vart kvar då sin mot sjølv ut sjå oss kom meg når viss hans".split()
        + "henne få vil enn år mellom seie to både slik dag gong denne seier utan".split()
        + "gjennom litt mann skulle vite tid tilbake først godt meir blir fram".split()
        + "enno går inn fordi ligg difor sidan får nettopp blant mange kjærleik".split()
        + "hjelp måte allereie ingen ingenting tre fekk framleis nett jo nei".split()
        + "alltid berre kanskje kroner arbeid korleis verda born gjerne norske".split()
        + "norsk oslo auge heim huset aldri nesten igjen store mindre pengar".split()
    ),
    "Bokmal": (
        "og i å det er en den til av som på de med han der ikke et var jeg".split()
        + "men seg har om vi hun hadde fra ham du kan nå over så skal ved kunne".split()
        + "eller hva deres etter opp under være dem også min alle noe mye her".split()
        + "hele andre ble hvor da sin mot selv ut se oss kom meg når hvis hans".split()
        + "henne få vil enn år mellom si to både slik dag gang denne sier uten".split()
        + "gjennom litt mann skulle vite tid tilbake først godt mer blir fram".split()
        + "ennå går inn fordi ligger derfor siden får nettopp blant mange".split()
        + "kjærlighet hjelp måte allerede ingen ingenting tre fikk fortsatt".split()
        + "akkurat jo nei alltid bare kanskje kroner arbeid hvordan verden barn".split()
        + "gjerne norske norsk oslo øyne hjem huset aldri nesten igjen store".split()
        + "vei været nei seier leilighet øye høy heter gate uke språk måned".split()
        + "setning vanskelig lærer tenke lenge ferdig treffe hjelpe søndag onsdag".split()
    ),
}


def _hash3(c1: int, c2: int, c3: int) -> int:
    """Deterministic trigram hash; identical formulation on host and device."""
    return (c1 * 961 + c2 * 31 + c3) & (TABLE_SIZE - 1)


def _hash3_vec(arr: "np.ndarray") -> "np.ndarray":
    """Vectorized :func:`_hash3` over a codepoint sequence ``[n] -> [n-2]``.
    Training and scoring must hash identically or the table silently
    mistrains.  The device kernel carries its own jnp twin of this formula
    (:mod:`textblaster_tpu.ops.langid_tpu`, ``langid_scores``) — change all
    three together, and the host/device parity suite will catch a miss."""
    return (arr[:-2] * 961 + arr[1:-1] * 31 + arr[2:]) & (TABLE_SIZE - 1)


# 31^-1 mod 2^32 — 31 is odd, hence invertible; lets the per-word rolling
# hash be computed from two prefix arrays instead of a Python loop.
_INV31 = np.uint32(pow(31, -1, 1 << 32))


def _word_hash_vec(arr: "np.ndarray") -> "np.ndarray":
    """Rolling hash ``h = h*31 + c`` of every boundary-delimited word in a
    normalized codepoint sequence (0 = boundary), masked to the table.

    Vectorized via modular inverses: with ``T_i = sum_{j<=i} c_j * 31^-j``
    (mod 2^32), the hash of span ``[a, b]`` is ``31^b * (T_b - T_{a-1})`` —
    exactly the loop's value, since 31 is invertible mod 2^32.  The device
    kernel computes the identical value with a segmented affine scan
    (:mod:`textblaster_tpu.ops.langid_tpu`)."""
    c = arr.astype(np.uint32)
    n = c.shape[0]
    if n == 0:
        return np.empty(0, dtype=np.int64)
    pow31 = np.ones(n, dtype=np.uint32)
    inv31 = np.ones(n, dtype=np.uint32)
    if n > 1:
        pow31[1:] = 31
        inv31[1:] = _INV31
        # NumPy promotes the cumprod accumulator to uint64; the final
        # uint32 cast truncates back to the intended mod-2^32 values.
        pow31 = np.cumprod(pow31).astype(np.uint32)
        inv31 = np.cumprod(inv31).astype(np.uint32)
    t = np.cumsum(c * inv31, dtype=np.uint32)
    is_b = arr == 0
    # Word spans [a, b]: a follows a boundary (or starts the array), b
    # precedes one (or ends it).  _normalize_codepoints wraps the stream in
    # boundaries, but stay robust to bare sequences.
    starts = np.flatnonzero(~is_b & np.concatenate(([True], is_b[:-1])))
    ends = np.flatnonzero(~is_b & np.concatenate((is_b[1:], [True])))
    if starts.size == 0:
        return np.empty(0, dtype=np.int64)
    t_prev = np.where(starts > 0, t[np.maximum(starts - 1, 0)], np.uint32(0))
    h = pow31[ends] * (t[ends] - t_prev)
    return (h & np.uint32(TABLE_SIZE - 1)).astype(np.int64)


def _normalize_codepoints(text: str) -> List[int]:
    """Lowercase letters kept; every other char becomes the boundary marker.

    Runs of boundary markers collapse, and the sequence is wrapped in
    boundaries, so word-edge trigrams are well-defined.  Training-time form
    (per-char Python); the hot scoring path uses the vectorized twin below.
    """
    out: List[int] = [0]
    for ch in text.lower():
        if ch.isalpha():
            out.append(ord(ch))
        elif out[-1] != 0:
            out.append(0)
    if out[-1] != 0:
        out.append(0)
    return out


def _norm_tables():
    """(lower [MAX_CP] int32, alpha-of-lower [MAX_CP] bool) — the same
    char/lower tables the device kernel gathers (ops/device.py), so the host
    scorer and the device kernel normalize identically by construction
    (including chars whose str.lower() is multi-char, which both treat as
    identity — unlike whole-string ``text.lower()``)."""
    global _NORM_TABLES
    if _NORM_TABLES is None:
        from ..ops.device import _class_table_np, _lower_table_np
        from ..utils import chartables as ct

        lower = _lower_table_np()
        alpha = (_class_table_np()[lower] & ct.ALPHA) != 0
        _NORM_TABLES = (lower, alpha)
    return _NORM_TABLES


_NORM_TABLES = None


def _normalize_vec(text: str) -> "np.ndarray":
    """Vectorized scoring-path twin of :func:`_normalize_codepoints`:
    boundary-wrapped lowercased letters with non-letter runs collapsed,
    as an int64 array."""
    from ..utils.chartables import codepoints

    lower, alpha = _norm_tables()
    arr = codepoints(text).astype(np.int64)
    clipped = np.minimum(arr, lower.shape[0] - 1)
    # Out-of-table codepoints are non-letters; `low` is only read at letter
    # positions, so the clipped gather is enough.
    low = lower[clipped]
    is_letter = np.zeros(arr.shape[0] + 2, dtype=bool)
    is_letter[1:-1] = alpha[clipped] & (arr < lower.shape[0])
    vals = np.zeros(arr.shape[0] + 2, dtype=np.int64)
    vals[1:-1] = np.where(is_letter[1:-1], low, 0)
    # Keep letters, plus the FIRST element of every non-letter run (the
    # collapsed boundary); the wrapping zeros make edges uniform.
    prev_letter = np.concatenate(([True], is_letter[:-1]))
    keep = is_letter | prev_letter
    return vals[keep]


# Fixed-point scale for the log-prob table: scores are summed as exact int32
# millinats on both host and device, so detection decisions are bit-identical
# across the two paths (no float accumulation-order dependence).
SCORE_SCALE = 1000.0


class LangIdModel:
    """Hashed-trigram naive-Bayes detector over the fixed candidate set."""

    def __init__(self) -> None:
        self.table = self._build_table()  # [TABLE_SIZE, n_langs] float32 log-probs
        self.table_q = np.round(self.table * SCORE_SCALE).astype(np.int32)

    @staticmethod
    def _build_table() -> np.ndarray:
        from .langid_data import EXTRA_WORDS, TRAIN_TEXT

        n_langs = len(LANGUAGES)
        counts = np.zeros((TABLE_SIZE, n_langs), dtype=np.float64)
        for li, lang in enumerate(LANGUAGES):
            # Function-word inventories, Zipf-weighted by rank: anchors the
            # high-frequency grammar of each language.
            for rank, word in enumerate(_WORDS[lang]):
                weight = 1.0 / (rank + 1.0)
                cps = _normalize_codepoints(word)
                for i in range(len(cps) - 2):
                    h = _hash3(cps[i], cps[i + 1], cps[i + 2])
                    counts[h, li] += weight
                # Bigram/unigram shadows at shifted buckets add robustness for
                # short inputs without a second table.
                for i in range(len(cps) - 1):
                    h = _hash3(0, cps[i], cps[i + 1])
                    counts[h, li] += 0.3 * weight
                arr = np.asarray(cps, dtype=np.int64)
                np.add.at(counts[:, li], _word_hash_vec(arr), 0.5 * weight)
            # Curated news-vocabulary lexicon, flat-weighted: whole-word and
            # trigram mass for the orthography that separates the close
            # pairs (Danish ud-/-hed/fik vs Bokmål ut-/-het/fikk).
            for word in EXTRA_WORDS[lang].split():
                arr = np.asarray(_normalize_codepoints(word), dtype=np.int64)
                if arr.shape[0] >= 3:
                    np.add.at(counts[:, li], _hash3_vec(arr), 1.0)
                np.add.at(counts[:, li], _word_hash_vec(arr), 1.0)
            # Running-text trigram + whole-word profile: content-word
            # orthography — the signal that separates the close Scandinavian
            # pairs (Danish 'af/-tion/øj' vs Bokmål 'av/-sjon/øy' vs Nynorsk
            # 'ikkje/kva').
            cps = _normalize_codepoints(TRAIN_TEXT[lang])
            arr = np.asarray(cps, dtype=np.int64)
            np.add.at(counts[:, li], _hash3_vec(arr), 0.5)
            np.add.at(counts[:, li], _word_hash_vec(arr), 0.25)
        alpha = 0.01
        totals = counts.sum(axis=0, keepdims=True)
        logp = np.log((counts + alpha) / (totals + alpha * TABLE_SIZE))
        return logp.astype(np.float32)

    def scores_q(self, text: str) -> Optional[Tuple[np.ndarray, int]]:
        """(int32 millinat score totals ``[n_langs]``, feature count), or None
        for letterless text.  Features are the character trigrams plus one
        whole-word hash per word.  Integer sums — the device kernel computes
        the same values exactly (:mod:`textblaster_tpu.ops.langid_tpu`)."""
        arr = _normalize_vec(text)
        if arr.shape[0] < 3:
            return None
        h = _hash3_vec(arr)
        wh = _word_hash_vec(arr)
        scores = self.table_q[h].sum(axis=0, dtype=np.int64)
        if wh.shape[0]:
            scores = scores + self.table_q[wh].sum(axis=0, dtype=np.int64)
        return scores, len(h) + wh.shape[0]

    @staticmethod
    def decide_batch(
        scores_q: np.ndarray, n_grams: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized decision over ``scores_q [B, n_langs]`` / ``n_grams [B]``
        -> ``(winner index [B], confidence [B])``.

        Confidence is the softmax probability of the winner over the candidate
        set, on length-normalized log-likelihoods re-scaled by a bounded
        evidence factor — short texts stay uncertain, long unambiguous texts
        approach 1.0, mirroring lingua's behavior.  All arithmetic is float64
        and row-wise identical to the scalar form, so host and device
        finalizers decide bit-identically.
        """
        ng = np.maximum(np.asarray(n_grams, dtype=np.int64), 1).astype(np.float64)
        s = np.asarray(scores_q).astype(np.float64) / SCORE_SCALE
        # Quadratic damping for tiny inputs (a 2-trigram fragment must stay
        # uncertain however lopsided its per-trigram scores), capped growth
        # for long ones.
        evidence = np.minimum(ng, 400.0) * (ng / (ng + 25.0))
        z = (s / ng[:, None]) * evidence[:, None]
        z = z - z.max(axis=1, keepdims=True)
        # Bound the spread so the winner's softmax stays strictly below 1.0
        # in float64 — lingua never reports exactly 1.0 either, and the
        # min_confidence=1.0 configuration must filter everything
        # (language_filter.rs:74-82 semantics).
        z = np.maximum(z, -30.0)
        p = np.exp(z)
        p /= p.sum(axis=1, keepdims=True)
        best = p.argmax(axis=1)
        return best, p[np.arange(p.shape[0]), best]

    @staticmethod
    def decide(scores_q: np.ndarray, n_grams: int) -> Tuple[str, float]:
        """Scalar form of :meth:`decide_batch` (one document)."""
        best, conf = LangIdModel.decide_batch(
            np.asarray(scores_q)[None, :], np.array([n_grams])
        )
        return LANGUAGES[int(best[0])], float(conf[0])

    def detect(self, text: str) -> Optional[Tuple[str, float]]:
        scored = self.scores_q(text)
        if scored is None:
            return None
        return self.decide(*scored)


_MODEL: Optional[LangIdModel] = None


def get_model() -> LangIdModel:
    """Process-wide model instance (profiles built once, reused everywhere —
    unlike the reference, which rebuilds its detector per document,
    language_filter.rs:39-46)."""
    global _MODEL
    if _MODEL is None:
        _MODEL = LangIdModel()
    return _MODEL
