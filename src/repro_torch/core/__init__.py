"""repro_torch.core — families, max-time moments, frontier, solver,
estimation; the counterpart of the JAX package's ``core``."""
from .distributions import (
    FAMILIES,
    ChannelFamily,
    Defective,
    Drift,
    Empirical,
    LogNormal,
    Normal,
    Phi,
    Phi_c,
    defective_moments_np,
    family_from_extra,
    get_family,
    phi,
    point_mass_cdf,
    remaining_work_stats,
    resolve_family,
    safe_cdf,
    scaled_channel_params,
)
from .maxstat import (
    clark_max_moments_2,
    clark_max_moments_seq,
    joint_cdf,
    joint_cdf_w,
    max_moments_mc,
    max_moments_quad,
    max_moments_quad_w,
    time_grid,
)
from .frontier import (
    FrontierResult,
    curve_2ch,
    curve_weights,
    frontier_2ch,
    frontier_kch,
    moments_for_split,
    pareto_mask,
    select_on_frontier,
    simplex_candidates,
)
from .partitioner import (
    PartitionDecision,
    equal_split,
    inverse_mu_split,
    objective,
    optimize_2ch,
    optimize_weights,
    predict_moments,
)
from .group import GroupChoice, select_channels, select_channels_exhaustive
from .bayes import (
    AUTO_FAMILIES,
    FamilyScores,
    NIGState,
    fit_selected_family,
    nig_estimate_ses,
    nig_init,
    nig_point_estimates,
    nig_update,
    nig_update_batch,
    score_families,
)
from .sensitivity import (
    MomentSensitivity,
    PosteriorSensitivity,
    estimation_fragility,
    fragility_batch,
    moment_sensitivity,
    posterior_sensitivity,
)

__all__ = [k for k in dir() if not k.startswith("_")]
