from .alerts import count_alerts, num_alerts, passes_alert_filter
from .descriptors import all_descriptors, crippen_logp, lipinski, qed, tpsa
from .fingerprint import morgan_fingerprint, pairwise_diversity, tanimoto
from .jsd import counter_jsd, hist_jsd, local3d_jsd
from .local3d import Local3D, match_paths
from .metrics import (
    RingAnalyzer,
    calculate_validity,
    count_prop,
    drug_chem,
    frags_counts,
    get_metric,
    groups_counts,
    ring_topo,
)
from .rmsd import best_embedding_rmsd, global_3d, kabsch_rmsd
from .sa_score import FragmentScorer, sa_score, set_default_fragment_scorer
from .similarity import SimilarityAnalysis
