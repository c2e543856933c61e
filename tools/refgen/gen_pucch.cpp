// PUCCH processor golden suites: synthesize PUCCH transmissions per
// TS 38.211 using the reference sequence primitives, pass them through a
// channel + noise, then run the REFERENCE pucch_processor
// (lib/phy/upper/channel_processors/pucch/pucch_processor_impl.cpp) and
// dump grid + configuration + reference outputs (UCI payload, detection
// status/metric).  tests/vectors/test_golden_pucch.py asserts the JAX
// framework's PUCCH receivers produce the same messages on the same grids.

#include "common.h"

#include "lib/phy/generic_functions/transform_precoding/transform_precoder_dft_impl.h"

#include "lib/phy/generic_functions/dft_processor_generic_impl.h"
#include "lib/phy/support/interpolator/interpolator_linear_impl.h"
#include "lib/phy/support/time_alignment_estimator/time_alignment_estimator_dft_impl.h"
#include "lib/phy/upper/channel_coding/crc_calculator_generic_impl.h"
#include "lib/phy/upper/channel_coding/polar/polar_code_impl.h"
#include "lib/phy/upper/channel_coding/polar/polar_decoder_impl.h"
#include "lib/phy/upper/channel_coding/polar/polar_deallocator_impl.h"
#include "lib/phy/upper/channel_coding/polar/polar_encoder_impl.h"
#include "lib/phy/upper/channel_coding/polar/polar_rate_dematcher_impl.h"
#include "lib/phy/upper/channel_coding/polar/polar_allocator_impl.h"
#include "lib/phy/upper/channel_coding/polar/polar_interleaver_impl.h"
#include "lib/phy/upper/channel_coding/polar/polar_rate_matcher_impl.h"
#include "lib/phy/upper/channel_coding/short/short_block_detector_impl.h"
#include "lib/phy/upper/channel_coding/short/short_block_encoder_impl.h"
#include "lib/phy/upper/channel_modulation/demodulation_mapper_impl.h"
#include "lib/phy/upper/channel_modulation/modulation_mapper_lut_impl.h"
#include "lib/phy/upper/channel_processors/pucch/pucch_demodulator_format2.h"
#include "lib/phy/upper/channel_processors/pucch/pucch_demodulator_format3.h"
#include "lib/phy/upper/channel_processors/pucch/pucch_demodulator_format4.h"
#include "lib/phy/upper/channel_processors/pucch/pucch_demodulator_impl.h"
#include "lib/phy/upper/channel_processors/pucch/pucch_detector_format0.h"
#include "lib/phy/upper/channel_processors/pucch/pucch_detector_format1.h"
#include "lib/phy/upper/channel_processors/pucch/pucch_detector_impl.h"
#include "lib/phy/upper/channel_processors/pucch/pucch_processor_impl.h"
#include "lib/phy/upper/channel_processors/uci/uci_decoder_impl.h"
#include "lib/phy/upper/equalization/channel_equalizer_generic_impl.h"
#include "lib/phy/upper/sequence_generators/low_papr_sequence_collection_impl.h"
#include "lib/phy/upper/sequence_generators/low_papr_sequence_generator_impl.h"
#include "lib/phy/upper/sequence_generators/pseudo_random_generator_impl.h"
#include "lib/phy/upper/signal_processors/pucch/dmrs_pucch_estimator_format2.h"
#include "lib/phy/upper/signal_processors/pucch/dmrs_pucch_estimator_formats3_4.h"
#include "lib/phy/upper/signal_processors/pucch/dmrs_pucch_estimator_impl.h"
#include "lib/phy/upper/signal_processors/channel_estimator/port_channel_estimator_average_impl.h"
#include "srsran/phy/support/resource_grid_reader.h"
#include "srsran/phy/upper/pucch_formats3_4_helpers.h"
#include "srsran/phy/upper/pucch_helper.h"
#include "srsran/phy/upper/pucch_orthogonal_sequence.h"
#include "srsran/ran/pucch/pucch_constants.h"
#include "srsran/srsvec/bit.h"

#include <cmath>
#include <random>

using namespace srsran;
using namespace refgen;

extern std::string g_root_outdir;

namespace {

void start(const std::string& name) { set_outdir(g_root_outdir + "/" + name); }

// Minimal dense resource grid (same role as gen_proc.cpp's demod_grid).
class pucch_grid : public resource_grid_reader {
public:
  pucch_grid(unsigned ports, unsigned symbols, unsigned subc)
      : ports_(ports), symbols_(symbols), subc_(subc), data_(ports * symbols * subc) {}
  cbf16_t& at(unsigned p, unsigned l, unsigned k) {
    return data_[(p * symbols_ + l) * subc_ + k];
  }
  const cbf16_t& at(unsigned p, unsigned l, unsigned k) const {
    return data_[(p * symbols_ + l) * subc_ + k];
  }
  unsigned get_nof_ports() const override { return ports_; }
  unsigned get_nof_subc() const override { return subc_; }
  unsigned get_nof_symbols() const override { return symbols_; }
  bool is_empty(unsigned) const override { return false; }
  bool is_empty() const override { return false; }
  span<cf_t> get(span<cf_t> symbols, unsigned port, unsigned l, unsigned k_init,
                 const bounded_bitset<MAX_RB * NRE>& mask) const override {
    unsigned i = 0;
    for (unsigned k = 0; k != mask.size(); ++k)
      if (mask.test(k)) symbols[i++] = to_cf(at(port, l, k_init + k));
    return symbols.last(symbols.size() - i);
  }
  span<cbf16_t> get(span<cbf16_t> symbols, unsigned port, unsigned l, unsigned k_init,
                    const bounded_bitset<MAX_RB * NRE>& mask) const override {
    unsigned i = 0;
    for (unsigned k = 0; k != mask.size(); ++k)
      if (mask.test(k)) symbols[i++] = at(port, l, k_init + k);
    return symbols.last(symbols.size() - i);
  }
  void get(span<cf_t> symbols, unsigned port, unsigned l, unsigned k_init,
           unsigned stride) const override {
    for (unsigned i = 0; i != symbols.size(); ++i)
      symbols[i] = to_cf(at(port, l, k_init + i * stride));
  }
  void get(span<cbf16_t> symbols, unsigned port, unsigned l, unsigned k_init) const override {
    for (unsigned i = 0; i != symbols.size(); ++i) symbols[i] = at(port, l, k_init + i);
  }
  span<const cbf16_t> get_view(unsigned port, unsigned l) const override {
    return span<const cbf16_t>(&at(port, l, 0), subc_);
  }

private:
  unsigned ports_, symbols_, subc_;
  std::vector<cbf16_t> data_;
};

std::unique_ptr<time_alignment_estimator> make_ta_est() {
  time_alignment_estimator_dft_impl::collection_dft_processors dfts;
  for (unsigned size = 128; size <= 4096; size *= 2) {
    dfts.emplace(size, std::make_unique<dft_processor_generic_impl>(
                           dft_processor::configuration{size, dft_processor::direction::INVERSE}));
  }
  return std::make_unique<time_alignment_estimator_dft_impl>(std::move(dfts));
}

std::unique_ptr<uci_decoder> make_uci_dec() {
  return std::make_unique<uci_decoder_impl>(
      std::make_unique<short_block_detector_impl>(),
      std::make_unique<polar_code_impl>(),
      std::make_unique<polar_rate_dematcher_impl>(),
      std::make_unique<polar_decoder_impl>(std::make_unique<polar_encoder_impl>(),
                                           polar_code::NMAX_LOG),
      std::make_unique<polar_deallocator_impl>(),
      std::make_unique<crc_calculator_generic_impl>(crc_generator_poly::CRC6),
      std::make_unique<crc_calculator_generic_impl>(crc_generator_poly::CRC11));
}

// TX-side UCI encoder mirroring uci_decoder_impl's polar chain
// (uci_decoder_impl.cpp:43-107): short block for A <= 11; otherwise
// CRC6/11 + polar(ibil) + rate match, 2 codeblocks with filler on the
// first when segmented.
std::vector<uint8_t> uci_encode_ref(span<const uint8_t> payload, unsigned E) {
  unsigned A = payload.size();
  std::vector<uint8_t> out(E);
  if (A <= 11) {
    short_block_encoder_impl sb;
    sb.encode(out, payload, modulation_scheme::QPSK);
    return out;
  }
  unsigned crc_size = (A >= 20) ? 11 : 6;
  bool segmented = (A >= 360 && E >= 1088) || (A >= 1013);
  unsigned nof_cb = segmented ? 2 : 1;
  crc_calculator_generic_impl crc6(crc_generator_poly::CRC6);
  crc_calculator_generic_impl crc11(crc_generator_poly::CRC11);
  crc_calculator& crc = (crc_size == 11) ? static_cast<crc_calculator&>(crc11)
                                         : static_cast<crc_calculator&>(crc6);
  polar_code_impl code;
  polar_allocator_impl allocator;
  polar_encoder_impl encoder;
  polar_rate_matcher_impl rm;
  unsigned cb0 = A / nof_cb;
  unsigned filler = A % nof_cb;
  unsigned pos_in = 0, pos_out = 0;
  for (unsigned i_cb = 0; i_cb != nof_cb; ++i_cb) {
    unsigned cb_msg = (i_cb == 0) ? cb0 : (A + nof_cb - 1) / nof_cb;
    unsigned cb_fill = (i_cb == 0) ? filler : 0;
    unsigned E_cb = E / nof_cb;
    unsigned K = cb_msg + cb_fill + crc_size;
    std::vector<uint8_t> a(K);
    for (unsigned j = 0; j != cb_fill; ++j) a[j] = 0;
    for (unsigned j = 0; j != cb_msg; ++j) a[cb_fill + j] = payload[pos_in + j];
    crc_calculator_checksum_t checksum =
        crc.calculate_bit(span<const uint8_t>(a.data(), cb_msg + cb_fill));
    for (unsigned j = 0; j != crc_size; ++j)
      a[cb_msg + cb_fill + j] = (checksum >> (crc_size - 1 - j)) & 1;
    code.set(K, E_cb, 10, polar_code_ibil::present);
    std::vector<uint8_t> allocated(code.get_N());
    allocator.allocate(allocated, a, code);
    std::vector<uint8_t> encoded(code.get_N());
    encoder.encode(encoded, allocated, code.get_n());
    std::vector<uint8_t> matched(E_cb);
    rm.rate_match(matched, encoded, code);
    std::copy(matched.begin(), matched.end(), out.begin() + pos_out);
    pos_in += cb_msg;
    pos_out += E_cb;
  }
  return out;
}

// Build the reference pucch_processor with all format paths.
std::unique_ptr<pucch_processor> make_processor(unsigned nof_prb, unsigned nof_ports) {
  std::array<float, NRE> alphas;
  for (unsigned n = 0; n != NRE; ++n)
    alphas[n] = 2.0F * static_cast<float>(M_PI) * static_cast<float>(n) / static_cast<float>(NRE);

  low_papr_sequence_generator_impl gen;
  auto coll0 = std::make_unique<low_papr_sequence_collection_impl>(gen, 1, 0, alphas);
  auto coll1 = std::make_unique<low_papr_sequence_collection_impl>(gen, 1, 0, alphas);

  auto det0 = std::make_unique<pucch_detector_format0>(
      std::make_unique<pseudo_random_generator_impl>(), std::move(coll0));
  auto det1 = std::make_unique<pucch_detector_format1>(
      std::move(coll1), std::make_unique<pseudo_random_generator_impl>(),
      std::make_unique<dft_processor_generic_impl>(
          dft_processor::configuration{NRE, dft_processor::direction::DIRECT}),
      std::make_unique<dft_processor_generic_impl>(
          dft_processor::configuration{NRE, dft_processor::direction::INVERSE}));
  auto detector = std::make_unique<pucch_detector_impl>(std::move(det0), std::move(det1));

  auto make_port_est = [] {
    return std::make_unique<port_channel_estimator_average_impl>(
        std::make_unique<interpolator_linear_impl>(), make_ta_est(),
        port_channel_estimator_fd_smoothing_strategy::filter,
        port_channel_estimator_td_interpolation_strategy::average,
        /*compensate_cfo=*/false);
  };
  auto est_f2 = std::make_unique<dmrs_pucch_estimator_format2>(
      std::make_unique<pseudo_random_generator_impl>(), make_port_est());
  auto est_f34 = std::make_unique<dmrs_pucch_estimator_formats3_4>(
      std::make_unique<pseudo_random_generator_impl>(),
      std::make_unique<low_papr_sequence_generator_impl>(), make_port_est());
  auto estimator = std::make_unique<dmrs_pucch_estimator_impl>(std::move(est_f2),
                                                               std::move(est_f34));

  auto make_eq = [] {
    return std::make_unique<channel_equalizer_generic_impl>(
        channel_equalizer_algorithm_type::mmse);
  };
  auto dem2 = std::make_unique<pucch_demodulator_format2>(
      make_eq(), std::make_unique<demodulation_mapper_impl>(),
      std::make_unique<pseudo_random_generator_impl>());
  auto dem3 = std::make_unique<pucch_demodulator_format3>(
      make_eq(), std::make_unique<demodulation_mapper_impl>(),
      std::make_unique<pseudo_random_generator_impl>(),
      std::make_unique<transform_precoder_dft_impl>([] {
        transform_precoder_dft_impl::collection_dft_processors dfts;
        for (unsigned rb : {1u, 2u, 3u, 4u, 5u, 6u, 8u, 9u, 10u, 12u, 15u, 16u}) {
          dfts.emplace(rb, std::make_unique<dft_processor_generic_impl>(
                               dft_processor::configuration{
                                   rb * NRE, dft_processor::direction::INVERSE}));
        }
        return dfts;
      }()));
  auto dem4 = std::make_unique<pucch_demodulator_format4>(
      make_eq(), std::make_unique<demodulation_mapper_impl>(),
      std::make_unique<pseudo_random_generator_impl>(),
      std::make_unique<transform_precoder_dft_impl>([] {
        transform_precoder_dft_impl::collection_dft_processors dfts;
        dfts.emplace(1, std::make_unique<dft_processor_generic_impl>(
                            dft_processor::configuration{
                                NRE, dft_processor::direction::INVERSE}));
        return dfts;
      }()));
  auto demodulator = std::make_unique<pucch_demodulator_impl>(
      std::move(dem2), std::move(dem3), std::move(dem4));

  channel_estimate::channel_estimate_dimensions ce_dims;
  ce_dims.nof_prb = nof_prb;
  ce_dims.nof_symbols = 14;
  ce_dims.nof_rx_ports = nof_ports;
  ce_dims.nof_tx_layers = 1;

  return std::make_unique<pucch_processor_impl>(
      std::make_unique<pucch_pdu_validator_impl>(ce_dims), std::move(estimator),
      std::move(detector), std::move(demodulator), make_uci_dec(), ce_dims);
}

// --- TS 38.211 TX helpers (reference primitives) ---------------------------

// m_cs for Format 0 per TS 38.213 Section 9.2.4 (matches the detector's
// dictionaries in pucch_detector_format0.cpp:45-66).
unsigned f0_m_cs(unsigned nof_harq, unsigned harq_bits, bool sr_opportunity, bool sr_positive) {
  if (nof_harq == 0) return 0;  // positive SR only
  if (nof_harq == 1) {
    unsigned base = (harq_bits & 1) ? 6 : 0;
    return base + (sr_opportunity && sr_positive ? 3 : 0);
  }
  // Index = b0 + 2*b1; TS 38.213 Table 9.2.3-4: (b0,b1) (0,0)->0, (1,0)->9,
  // (0,1)->3, (1,1)->6 (matches pucch_detector_format0_twoharq_nosr).
  static const unsigned two[4] = {0, 9, 3, 6};
  unsigned base = two[harq_bits & 3];
  return base + (sr_opportunity && sr_positive ? 1 : 0);
}

struct chan_model {
  std::mt19937& rng;
  float nstd;
  unsigned nof_ports;
  std::normal_distribution<float> nd{0.f, 1.f};
  // Per-port flat-ish channel with a linear phase ramp.
  cf_t h(unsigned port, unsigned k) {
    float ph = 2.f * (float)M_PI * (0.05f + 0.04f * port) * k / (float)NRE;
    float amp = 1.0f;
    return amp * cf_t(std::cos(ph), std::sin(ph));
  }
  cf_t noise() { return nstd * cf_t(nd(rng), nd(rng)); }
};

void dump_grid(pucch_grid& grid, unsigned ports, unsigned subc, const std::string& name) {
  std::vector<cf_t> dump;
  for (unsigned p = 0; p != ports; ++p)
    for (unsigned s = 0; s != 14; ++s)
      for (unsigned k = 0; k != subc; ++k) dump.push_back(to_cf(grid.at(p, s, k)));
  write_dat(name, reinterpret_cast<const float*>(dump.data()), 2 * dump.size());
}

// --- Format 0 suite --------------------------------------------------------

void gen_pucch_format0() {
  start("pucch_format0");
  manifest m("manifest.json");
  auto rng = make_rng(0xF0F0);

  pucch_helper helper(std::make_unique<pseudo_random_generator_impl>());
  low_papr_sequence_generator_impl seq_gen;

  struct f0case {
    unsigned bwp_rb, prb, start_sym, nof_syms, m0, n_id, slot_idx;
    unsigned nof_harq, harq_bits;
    bool sr_opportunity, sr_positive;
    bool transmit;  // false => DTX case
    float snr_db;
    unsigned ports;
    int second_hop_prb = -1;  // >=0: intra-slot frequency hopping
  };
  std::vector<f0case> cases = {
      {52, 3, 13, 1, 0, 42, 2, 1, 1, false, false, true, 20.f, 1},
      {52, 10, 12, 2, 5, 301, 5, 2, 2, false, false, true, 20.f, 1},
      {106, 51, 13, 1, 3, 77, 1, 2, 1, true, true, true, 20.f, 2},
      {52, 7, 13, 1, 0, 42, 3, 0, 0, true, true, true, 20.f, 1},
      {52, 3, 13, 1, 0, 42, 2, 1, 0, false, false, false, 20.f, 1},  // DTX
      // Intra-slot frequency hopping (2 symbols, second on PRB 40).
      {52, 3, 12, 2, 2, 42, 6, 2, 3, false, false, true, 20.f, 1, 40},
  };

  int idx = 0;
  for (const auto& c : cases) {
    unsigned subc = c.bwp_rb * NRE;
    pucch_grid grid(c.ports, 14, subc);
    float nstd = std::sqrt(std::pow(10.f, -c.snr_db / 10.f) / 2.f);
    chan_model ch{rng, nstd, c.ports};

    slot_point slot(to_numerology_value(subcarrier_spacing::kHz30), c.slot_idx);

    // Noise everywhere in the PUCCH PRB (the detector only reads it).
    for (unsigned p = 0; p != c.ports; ++p)
      for (unsigned s = 0; s != 14; ++s)
        for (unsigned k = 0; k != subc; ++k) grid.at(p, s, k) = to_cbf16(ch.noise());

    if (c.transmit) {
      unsigned m_cs = f0_m_cs(c.nof_harq, c.harq_bits, c.sr_opportunity, c.sr_positive);
      auto [u, v] = pucch_helper::compute_group_sequence(pucch_group_hopping::NEITHER, c.n_id);
      for (unsigned s = 0; s != c.nof_syms; ++s) {
        unsigned sym = c.start_sym + s;
        unsigned prb = (s > 0 && c.second_hop_prb >= 0) ? (unsigned)c.second_hop_prb
                                                        : c.prb;
        unsigned alpha_idx = helper.get_alpha_index(slot, cyclic_prefix::NORMAL, c.n_id,
                                                    sym, c.m0, m_cs);
        std::array<cf_t, NRE> r;
        seq_gen.generate(r, u, v, alpha_idx, NRE);
        for (unsigned p = 0; p != c.ports; ++p)
          for (unsigned k = 0; k != NRE; ++k)
            grid.at(p, sym, prb * NRE + k) =
                to_cbf16(r[k] * ch.h(p, k) + ch.noise());
      }
    }

    // Reference RX.
    auto proc = make_processor(c.bwp_rb, c.ports);
    pucch_processor::format0_configuration cfg;
    cfg.slot = slot;
    cfg.cp = cyclic_prefix::NORMAL;
    cfg.bwp_size_rb = c.bwp_rb;
    cfg.bwp_start_rb = 0;
    cfg.starting_prb = c.prb;
    cfg.second_hop_prb = (c.second_hop_prb >= 0)
                             ? std::optional<unsigned>((unsigned)c.second_hop_prb)
                             : std::nullopt;
    cfg.start_symbol_index = c.start_sym;
    cfg.nof_symbols = c.nof_syms;
    cfg.initial_cyclic_shift = c.m0;
    cfg.n_id = c.n_id;
    cfg.nof_harq_ack = c.nof_harq;
    cfg.sr_opportunity = c.sr_opportunity;
    for (unsigned p = 0; p != c.ports; ++p) cfg.ports.push_back(p);

    pucch_processor_result res = proc->process(grid, cfg);

    std::string base = std::to_string(idx);
    dump_grid(grid, c.ports, subc, "grid" + base + ".dat");

    bool valid = res.message.get_status() == uci_status::valid;
    unsigned harq_out = 0;
    for (unsigned i = 0; i != res.message.get_harq_ack_bits().size(); ++i)
      harq_out |= (unsigned)res.message.get_harq_ack_bits()[i] << i;
    unsigned sr_out = res.message.get_sr_bits().empty()
                          ? 0 : (unsigned)res.message.get_sr_bits()[0];

    m.begin_case();
    m.field("idx", (long long)idx);
    m.field("bwp_rb", (long long)c.bwp_rb);
    m.field("prb", (long long)c.prb);
    m.field("start_sym", (long long)c.start_sym);
    m.field("nof_syms", (long long)c.nof_syms);
    m.field("m0", (long long)c.m0);
    m.field("n_id", (long long)c.n_id);
    m.field("slot_idx", (long long)c.slot_idx);
    m.field("nof_harq", (long long)c.nof_harq);
    m.field("harq_tx", (long long)c.harq_bits);
    m.field("sr_opportunity", (long long)(c.sr_opportunity ? 1 : 0));
    m.field("sr_tx", (long long)(c.sr_positive ? 1 : 0));
    m.field("transmit", (long long)(c.transmit ? 1 : 0));
    m.field("ports", (long long)c.ports);
    m.field("second_hop_prb", (long long)c.second_hop_prb);
    m.field("ref_valid", (long long)(valid ? 1 : 0));
    m.field("ref_harq", (long long)harq_out);
    m.field("ref_sr", (long long)sr_out);
    m.end_case();
    ++idx;
  }
  m.flush();
}

// --- Format 1 suite --------------------------------------------------------

void gen_pucch_format1() {
  start("pucch_format1");
  manifest m("manifest.json");
  auto rng = make_rng(0xF1F1);

  pucch_helper helper(std::make_unique<pseudo_random_generator_impl>());
  low_papr_sequence_generator_impl seq_gen;
  pucch_orthogonal_sequence_format1 occ;

  struct f1ue {
    unsigned m0, occi, nof_harq, harq_bits;
  };
  struct f1case {
    unsigned bwp_rb, prb, start_sym, nof_syms, n_id, slot_idx;
    float snr_db;
    unsigned ports;
    std::vector<f1ue> ues;
    int second_hop_prb = -1;
  };
  std::vector<f1case> cases = {
      {52, 11, 0, 14, 17, 4, 20.f, 1, {{0, 0, 1, 1}}},
      {52, 11, 0, 14, 17, 4, 20.f, 1, {{0, 0, 2, 2}}},
      {106, 40, 2, 12, 500, 8, 20.f, 2, {{3, 1, 2, 1}}},
      // Two UEs multiplexed on the same resource (different ICS + OCC).
      {52, 5, 0, 14, 99, 1, 20.f, 1, {{0, 0, 1, 1}, {6, 3, 1, 0}}},
      {52, 5, 4, 10, 99, 9, 22.f, 1, {{2, 1, 2, 3}}},
      // Intra-slot frequency hopping: second hop on PRB 45, OCC restarts.
      {52, 5, 0, 14, 17, 2, 22.f, 1, {{0, 0, 2, 1}}, 45},
  };

  int idx = 0;
  for (const auto& c : cases) {
    unsigned subc = c.bwp_rb * NRE;
    pucch_grid grid(c.ports, 14, subc);
    float nstd = std::sqrt(std::pow(10.f, -c.snr_db / 10.f) / 2.f);
    chan_model ch{rng, nstd, c.ports};
    slot_point slot(to_numerology_value(subcarrier_spacing::kHz30), c.slot_idx);

    // Start from pure noise in the allocated PRB.
    for (unsigned p = 0; p != c.ports; ++p)
      for (unsigned s = 0; s != 14; ++s)
        for (unsigned k = 0; k != subc; ++k) grid.at(p, s, k) = to_cbf16(ch.noise());

    // Clear PUCCH REs so multiplexed UEs superpose over a clean slate, then
    // add noise back once.
    for (unsigned p = 0; p != c.ports; ++p)
      for (unsigned s = 0; s != c.nof_syms; ++s)
        for (unsigned k = 0; k != NRE; ++k)
          grid.at(p, c.start_sym + s, c.prb * NRE + k) = to_cbf16(ch.noise());

    auto [u, v] = pucch_helper::compute_group_sequence(pucch_group_hopping::NEITHER, c.n_id);
    // Hop boundaries: one hop without hopping, split at nof_syms/2 with.
    unsigned hop_split = (c.second_hop_prb >= 0) ? c.nof_syms / 2 : c.nof_syms;

    for (const auto& ue : c.ues) {
      // Modulation symbol d: BPSK (1 bit) / QPSK (2 bits), TS 38.211 5.1.2/5.1.3.
      cf_t d;
      if (ue.nof_harq == 1) {
        float s0 = (ue.harq_bits & 1) ? -(float)M_SQRT1_2 : (float)M_SQRT1_2;
        d = cf_t(s0, s0);
      } else {
        float re = (ue.harq_bits & 1) ? -(float)M_SQRT1_2 : (float)M_SQRT1_2;
        float im = (ue.harq_bits & 2) ? -(float)M_SQRT1_2 : (float)M_SQRT1_2;
        d = cf_t(re, im);
      }
      for (unsigned hop = 0; hop != (c.second_hop_prb >= 0 ? 2u : 1u); ++hop) {
        unsigned s_begin = (hop == 0) ? 0 : hop_split;
        unsigned s_end = (hop == 0) ? hop_split : c.nof_syms;
        unsigned prb = (hop == 0) ? c.prb : (unsigned)c.second_hop_prb;
        unsigned n_dmrs_sf = 0, n_data_sf = 0;
        for (unsigned s = s_begin; s != s_end; ++s)
          ((s % 2 == 0) ? n_dmrs_sf : n_data_sf) += 1;
        unsigned i_data = 0, i_dmrs = 0;
        for (unsigned s = s_begin; s != s_end; ++s) {
          unsigned sym = c.start_sym + s;
          unsigned alpha_idx = helper.get_alpha_index(slot, cyclic_prefix::NORMAL,
                                                      c.n_id, sym, ue.m0, 0);
          std::array<cf_t, NRE> r;
          seq_gen.generate(r, u, v, alpha_idx, NRE);
          bool is_dmrs = (s % 2 == 0);
          cf_t w = is_dmrs ? occ.get_sequence_value(n_dmrs_sf, ue.occi, i_dmrs)
                           : occ.get_sequence_value(n_data_sf, ue.occi, i_data);
          cf_t scale = is_dmrs ? w : d * w;
          if (is_dmrs) ++i_dmrs; else ++i_data;
          for (unsigned p = 0; p != c.ports; ++p)
            for (unsigned k = 0; k != NRE; ++k) {
              cf_t cur = to_cf(grid.at(p, sym, prb * NRE + k));
              grid.at(p, sym, prb * NRE + k) =
                  to_cbf16(cur + scale * r[k] * ch.h(p, k));
            }
        }
      }
    }

    // Reference RX: batch with one entry per UE.
    auto proc = make_processor(c.bwp_rb, c.ports);
    pucch_processor::format1_batch_configuration batch;
    batch.common_config.slot = slot;
    batch.common_config.bwp_size_rb = c.bwp_rb;
    batch.common_config.bwp_start_rb = 0;
    batch.common_config.cp = cyclic_prefix::NORMAL;
    batch.common_config.starting_prb = c.prb;
    batch.common_config.second_hop_prb =
        (c.second_hop_prb >= 0) ? std::optional<unsigned>((unsigned)c.second_hop_prb)
                                : std::nullopt;
    batch.common_config.n_id = c.n_id;
    batch.common_config.nof_symbols = c.nof_syms;
    batch.common_config.start_symbol_index = c.start_sym;
    for (unsigned p = 0; p != c.ports; ++p) batch.common_config.ports.push_back(p);
    for (const auto& ue : c.ues)
      batch.entries.insert(ue.m0, ue.occi, {std::nullopt, (uint16_t)ue.nof_harq});

    const auto& results = proc->process(grid, batch);

    std::string base = std::to_string(idx);
    dump_grid(grid, c.ports, subc, "grid" + base + ".dat");

    m.begin_case();
    m.field("idx", (long long)idx);
    m.field("bwp_rb", (long long)c.bwp_rb);
    m.field("prb", (long long)c.prb);
    m.field("start_sym", (long long)c.start_sym);
    m.field("nof_syms", (long long)c.nof_syms);
    m.field("n_id", (long long)c.n_id);
    m.field("slot_idx", (long long)c.slot_idx);
    m.field("ports", (long long)c.ports);
    m.field("second_hop_prb", (long long)c.second_hop_prb);
    m.field("nof_ues", (long long)c.ues.size());
    int iu = 0;
    for (const auto& ue : c.ues) {
      const auto& r = results.get(ue.m0, ue.occi);
      bool valid = r.message.get_status() == uci_status::valid;
      unsigned harq_out = 0;
      for (unsigned i = 0; i != r.message.get_harq_ack_bits().size(); ++i)
        harq_out |= (unsigned)r.message.get_harq_ack_bits()[i] << i;
      std::string pre = "ue" + std::to_string(iu) + "_";
      m.field(pre + "m0", (long long)ue.m0);
      m.field(pre + "occi", (long long)ue.occi);
      m.field(pre + "nof_harq", (long long)ue.nof_harq);
      m.field(pre + "harq_tx", (long long)ue.harq_bits);
      m.field(pre + "ref_valid", (long long)(valid ? 1 : 0));
      m.field(pre + "ref_harq", (long long)harq_out);
      ++iu;
    }
    m.end_case();
    ++idx;
  }
  m.flush();
}

// --- Format 2 suite --------------------------------------------------------

void gen_pucch_format2() {
  start("pucch_format2");
  manifest m("manifest.json");
  auto rng = make_rng(0xF2F2);

  struct f2case {
    unsigned bwp_rb, prb, nof_prb, start_sym, nof_syms;
    unsigned rnti, n_id, n_id0, slot_idx;
    unsigned nof_harq, nof_sr, nof_csi1;
    float snr_db;
    unsigned ports;
    int second_hop_prb = -1;
  };
  std::vector<f2case> cases = {
      {52, 0, 1, 13, 1, 0x4601, 42, 17, 2, 3, 0, 0, 20.f, 1},
      {52, 4, 2, 12, 2, 0x1234, 301, 301, 5, 4, 1, 4, 20.f, 1},
      {106, 20, 4, 12, 2, 0x17a1, 77, 901, 8, 6, 1, 4, 20.f, 2},
      {52, 10, 3, 13, 1, 0x900d, 10, 10, 1, 11, 0, 0, 22.f, 1},
      // Polar-coded UCI (A > 11): CRC6 regime and CRC11 regime.
      {52, 0, 4, 12, 2, 0x4601, 42, 17, 4, 16, 0, 0, 22.f, 1},
      {52, 20, 6, 12, 2, 0x1234, 301, 301, 6, 29, 1, 10, 22.f, 1},
      // Intra-slot frequency hopping: second symbol at PRB 30.
      {52, 2, 3, 12, 2, 0x77aa, 55, 55, 7, 7, 1, 0, 22.f, 1, 30},
  };

  short_block_encoder_impl sb_enc;
  modulation_mapper_lut_impl mapper;

  int idx = 0;
  for (const auto& c : cases) {
    unsigned subc = c.bwp_rb * NRE;
    unsigned A = c.nof_harq + c.nof_sr + c.nof_csi1;
    unsigned E = c.nof_prb * 8 * c.nof_syms * 2;  // 8 data REs/PRB, QPSK
    pucch_grid grid(c.ports, 14, subc);
    float nstd = std::sqrt(std::pow(10.f, -c.snr_db / 10.f) / 2.f);
    chan_model ch{rng, nstd, c.ports};
    slot_point slot(to_numerology_value(subcarrier_spacing::kHz30), c.slot_idx);

    // Payload and encoding (TS 38.212 short block, A in [3, 11]).
    std::vector<uint8_t> payload(A);
    for (auto& b : payload) b = rng() & 1;
    std::vector<uint8_t> coded = uci_encode_ref(payload, E);

    // Scramble (TS 38.211 6.3.2.5.1) and QPSK-map.
    pseudo_random_generator_impl scr;
    scr.init((unsigned)c.rnti * pow2(15) + c.n_id);
    scr.apply_xor(coded, coded);
    dynamic_bit_buffer packed(E);
    srsvec::bit_pack(packed, coded);
    std::vector<cf_t> x(E / 2);
    mapper.modulate(x, packed, modulation_scheme::QPSK);

    // Noise floor.
    for (unsigned p = 0; p != c.ports; ++p)
      for (unsigned s = 0; s != 14; ++s)
        for (unsigned k = 0; k != subc; ++k) grid.at(p, s, k) = to_cbf16(ch.noise());

    // Map data (k%3 != 1) and DM-RS (k%3 == 1; TS 38.211 6.4.1.3.2).
    pseudo_random_generator_impl dmrs_prg;
    unsigned data_i = 0;
    for (unsigned s = 0; s != c.nof_syms; ++s) {
      unsigned sym = c.start_sym + s;
      unsigned hop_prb = (s > 0 && c.second_hop_prb >= 0)
                             ? (unsigned)c.second_hop_prb : c.prb;
      unsigned c_init =
          ((14ull * c.slot_idx + sym + 1) * (2ull * c.n_id0 + 1) * pow2(17) +
           2ull * c.n_id0) % pow2(31);
      dmrs_prg.init(c_init);
      dmrs_prg.advance(hop_prb * 4 * 2);
      std::vector<cf_t> pil(c.nof_prb * 4);
      static_cast<pseudo_random_generator&>(dmrs_prg).generate(span<cf_t>(pil), (float)M_SQRT1_2);
      unsigned pi = 0;
      for (unsigned rb = 0; rb != c.nof_prb; ++rb) {
        for (unsigned re = 0; re != NRE; ++re) {
          unsigned k = (hop_prb + rb) * NRE + re;
          cf_t v = (re % 3 == 1) ? pil[pi++] : x[data_i++];
          for (unsigned p = 0; p != c.ports; ++p) {
            cf_t cur = to_cf(grid.at(p, sym, k));
            grid.at(p, sym, k) = to_cbf16(cur + v * ch.h(p, k % NRE));
          }
        }
      }
    }

    // Reference RX.
    auto proc = make_processor(c.bwp_rb, c.ports);
    pucch_processor::format2_configuration cfg;
    cfg.slot = slot;
    cfg.cp = cyclic_prefix::NORMAL;
    for (unsigned p = 0; p != c.ports; ++p) cfg.ports.push_back(p);
    cfg.bwp_size_rb = c.bwp_rb;
    cfg.bwp_start_rb = 0;
    cfg.starting_prb = c.prb;
    cfg.second_hop_prb = (c.second_hop_prb >= 0)
                             ? std::optional<unsigned>((unsigned)c.second_hop_prb)
                             : std::nullopt;
    cfg.nof_prb = c.nof_prb;
    cfg.start_symbol_index = c.start_sym;
    cfg.nof_symbols = c.nof_syms;
    cfg.rnti = c.rnti;
    cfg.n_id = c.n_id;
    cfg.n_id_0 = c.n_id0;
    cfg.nof_harq_ack = c.nof_harq;
    cfg.nof_sr = c.nof_sr;
    cfg.nof_csi_part1 = c.nof_csi1;
    cfg.nof_csi_part2 = 0;

    pucch_processor_result res = proc->process(grid, cfg);

    std::string base = std::to_string(idx);
    dump_grid(grid, c.ports, subc, "grid" + base + ".dat");
    write_dat("payload" + base + ".dat", payload);

    bool valid = res.message.get_status() == uci_status::valid;
    std::vector<uint8_t> ref_bits;
    for (auto b : res.message.get_harq_ack_bits()) ref_bits.push_back(b);
    for (auto b : res.message.get_sr_bits()) ref_bits.push_back(b);
    for (auto b : res.message.get_csi_part1_bits()) ref_bits.push_back(b);
    write_dat("ref_bits" + base + ".dat", ref_bits);

    m.begin_case();
    m.field("idx", (long long)idx);
    m.field("bwp_rb", (long long)c.bwp_rb);
    m.field("prb", (long long)c.prb);
    m.field("nof_prb", (long long)c.nof_prb);
    m.field("start_sym", (long long)c.start_sym);
    m.field("nof_syms", (long long)c.nof_syms);
    m.field("rnti", (long long)c.rnti);
    m.field("n_id", (long long)c.n_id);
    m.field("n_id0", (long long)c.n_id0);
    m.field("slot_idx", (long long)c.slot_idx);
    m.field("nof_harq", (long long)c.nof_harq);
    m.field("nof_sr", (long long)c.nof_sr);
    m.field("nof_csi1", (long long)c.nof_csi1);
    m.field("ports", (long long)c.ports);
    m.field("second_hop_prb", (long long)c.second_hop_prb);
    m.field("ref_valid", (long long)(valid ? 1 : 0));
    m.end_case();
    ++idx;
  }
  m.flush();
}

// --- Format 3/4 suite ------------------------------------------------------

void gen_pucch_format34() {
  start("pucch_format34");
  manifest m("manifest.json");
  auto rng = make_rng(0xF3F4);

  pucch_helper helper(std::make_unique<pseudo_random_generator_impl>());
  low_papr_sequence_generator_impl seq_gen;
  short_block_encoder_impl sb_enc;
  modulation_mapper_lut_impl mapper;

  struct f34case {
    unsigned bwp_rb, prb, nof_prb, start_sym, nof_syms;
    unsigned rnti, n_id, slot_idx;
    unsigned nof_harq, nof_sr, nof_csi1;
    unsigned occ_length, occ_index;  // occ_length 1 => format 3
    float snr_db;
    unsigned ports;
    int second_hop_prb = -1;
    bool additional_dmrs = false;
    bool pi2_bpsk = false;
  };
  std::vector<f34case> cases = {
      // Format 3.
      {52, 0, 1, 0, 14, 0x4601, 42, 2, 4, 0, 0, 1, 0, 20.f, 1},
      {52, 8, 2, 4, 10, 0x1234, 301, 7, 6, 1, 4, 1, 0, 20.f, 1},
      {106, 30, 4, 9, 5, 0x17a1, 77, 3, 11, 0, 0, 1, 0, 22.f, 2},
      // Format 4 (1 PRB, pre-DFT OCC).
      {52, 5, 1, 0, 14, 0x900d, 10, 6, 4, 0, 0, 2, 1, 20.f, 1},
      {52, 5, 1, 0, 14, 0x77aa, 55, 8, 3, 0, 0, 4, 3, 22.f, 1},
      // Format 3 with polar-coded UCI (A = 25, CRC11).
      {52, 12, 2, 0, 14, 0x2468, 77, 4, 20, 1, 4, 1, 0, 22.f, 1},
      // Format 3 with intra-slot frequency hopping (second hop PRB 40),
      // and the hopping DM-RS table for the 4-symbol case.
      {52, 2, 2, 0, 14, 0x1357, 99, 5, 6, 1, 0, 1, 0, 22.f, 1, 40},
      {52, 6, 1, 10, 4, 0x9bdf, 11, 9, 5, 0, 0, 1, 0, 22.f, 1, 30},
      // additionalDMRS: 4 DM-RS symbols on a 14-symbol Format 3.
      {52, 8, 2, 0, 14, 0x2460, 33, 1, 8, 1, 0, 1, 0, 22.f, 1, -1, true},
      // pi/2-BPSK data modulation on Format 3.
      {52, 16, 1, 0, 14, 0x8642, 21, 3, 7, 0, 0, 1, 0, 22.f, 1, -1, false, true},
  };

  int idx = 0;
  for (const auto& c : cases) {
    unsigned subc = c.bwp_rb * NRE;
    unsigned m_sc = c.nof_prb * NRE;
    unsigned A = c.nof_harq + c.nof_sr + c.nof_csi1;
    pucch_grid grid(c.ports, 14, subc);
    float nstd = std::sqrt(std::pow(10.f, -c.snr_db / 10.f) / 2.f);
    chan_model ch{rng, nstd, c.ports};
    slot_point slot(to_numerology_value(subcarrier_spacing::kHz30), c.slot_idx);

    bool hopping = (c.second_hop_prb >= 0);
    symbol_slot_mask dmrs_mask = get_pucch_formats3_4_dmrs_symbol_mask(
        c.nof_syms, hopping, c.additional_dmrs);
    unsigned nof_data_syms = c.nof_syms - dmrs_mask.count();
    unsigned qm = c.pi2_bpsk ? 1 : 2;
    unsigned E = nof_data_syms * m_sc * qm / c.occ_length;

    // Encode + scramble + modulate.
    std::vector<uint8_t> payload(A);
    for (auto& b : payload) b = rng() & 1;
    std::vector<uint8_t> coded = uci_encode_ref(payload, E);
    pseudo_random_generator_impl scr;
    scr.init((unsigned)c.rnti * pow2(15) + c.n_id);
    scr.apply_xor(coded, coded);
    dynamic_bit_buffer packed(E);
    srsvec::bit_pack(packed, coded);
    std::vector<cf_t> d(E / qm);
    mapper.modulate(d, packed,
                    c.pi2_bpsk ? modulation_scheme::PI_2_BPSK
                               : modulation_scheme::QPSK);

    // Forward DFT (transform precoding TX side: 1/sqrt(M_sc) scaling).
    dft_processor_generic_impl dft(
        dft_processor::configuration{m_sc, dft_processor::direction::DIRECT});

    // Noise floor.
    for (unsigned p = 0; p != c.ports; ++p)
      for (unsigned s = 0; s != 14; ++s)
        for (unsigned k = 0; k != subc; ++k) grid.at(p, s, k) = to_cbf16(ch.noise());

    auto [u, v] = pucch_helper::compute_group_sequence(pucch_group_hopping::NEITHER, c.n_id);
    // Format 4 DM-RS m0 per TS 38.211 Table 6.4.1.3.3.1-1 (estimator
    // dmrs_pucch_estimator_formats3_4.cpp:34-50); Format 3 uses m0 = 0.
    unsigned m0 = 0;
    if (c.occ_length > 1) {
      static const unsigned m0_table[4] = {0, 6, 3, 9};
      m0 = m0_table[c.occ_index];
    }

    unsigned mod = NRE / std::max(c.occ_length, 1u);
    span<const cf_t> wn;
    if (c.occ_length > 1)
      wn = pucch_orthogonal_sequence_format4::get_sequence(c.occ_length, c.occ_index);

    unsigned i_data_sym = 0;
    for (unsigned s = 0; s != c.nof_syms; ++s) {
      unsigned sym = c.start_sym + s;
      unsigned hop_prb = (hopping && s >= c.nof_syms / 2)
                             ? (unsigned)c.second_hop_prb : c.prb;
      std::vector<cf_t> x(m_sc);
      if (dmrs_mask.test(s)) {
        unsigned alpha_idx = helper.get_alpha_index(slot, cyclic_prefix::NORMAL,
                                                    c.n_id, sym, m0, 0);
        seq_gen.generate(x, u, v, alpha_idx, NRE);
      } else {
        // Block-wise spreading (F4) or plain block (F3), then DFT.
        std::vector<cf_t> y(m_sc);
        const cf_t* block = &d[i_data_sym * (m_sc / c.occ_length)];
        for (unsigned k = 0; k != m_sc; ++k)
          y[k] = (c.occ_length > 1) ? wn[k] * block[k % mod] : block[k];
        srsvec::copy(dft.get_input(), y);
        span<const cf_t> out = dft.run();
        for (unsigned k = 0; k != m_sc; ++k)
          x[k] = out[k] / std::sqrt((float)m_sc);
        ++i_data_sym;
      }
      for (unsigned p = 0; p != c.ports; ++p)
        for (unsigned k = 0; k != m_sc; ++k) {
          cf_t cur = to_cf(grid.at(p, sym, hop_prb * NRE + k));
          grid.at(p, sym, hop_prb * NRE + k) = to_cbf16(cur * 0.0f + x[k] * ch.h(p, k % NRE) + ch.noise());
        }
    }

    // Reference RX.
    auto proc = make_processor(c.bwp_rb, c.ports);
    pucch_processor_result res;
    if (c.occ_length == 1) {
      pucch_processor::format3_configuration cfg;
      cfg.slot = slot;
      cfg.cp = cyclic_prefix::NORMAL;
      for (unsigned p = 0; p != c.ports; ++p) cfg.ports.push_back(p);
      cfg.bwp_size_rb = c.bwp_rb;
      cfg.bwp_start_rb = 0;
      cfg.starting_prb = c.prb;
      cfg.second_hop_prb = hopping ? std::optional<unsigned>((unsigned)c.second_hop_prb)
                                   : std::nullopt;
      cfg.nof_prb = c.nof_prb;
      cfg.start_symbol_index = c.start_sym;
      cfg.nof_symbols = c.nof_syms;
      cfg.rnti = c.rnti;
      cfg.n_id_hopping = c.n_id;
      cfg.n_id_scrambling = c.n_id;
      cfg.nof_harq_ack = c.nof_harq;
      cfg.nof_sr = c.nof_sr;
      cfg.nof_csi_part1 = c.nof_csi1;
      cfg.nof_csi_part2 = 0;
      cfg.additional_dmrs = c.additional_dmrs;
      cfg.pi2_bpsk = c.pi2_bpsk;
      res = proc->process(grid, cfg);
    } else {
      pucch_processor::format4_configuration cfg;
      cfg.slot = slot;
      cfg.cp = cyclic_prefix::NORMAL;
      for (unsigned p = 0; p != c.ports; ++p) cfg.ports.push_back(p);
      cfg.bwp_size_rb = c.bwp_rb;
      cfg.bwp_start_rb = 0;
      cfg.starting_prb = c.prb;
      cfg.second_hop_prb = hopping ? std::optional<unsigned>((unsigned)c.second_hop_prb)
                                   : std::nullopt;
      cfg.start_symbol_index = c.start_sym;
      cfg.nof_symbols = c.nof_syms;
      cfg.rnti = c.rnti;
      cfg.n_id_hopping = c.n_id;
      cfg.n_id_scrambling = c.n_id;
      cfg.nof_harq_ack = c.nof_harq;
      cfg.nof_sr = c.nof_sr;
      cfg.nof_csi_part1 = c.nof_csi1;
      cfg.nof_csi_part2 = 0;
      cfg.additional_dmrs = false;
      cfg.pi2_bpsk = false;
      cfg.occ_index = c.occ_index;
      cfg.occ_length = c.occ_length;
      res = proc->process(grid, cfg);
    }

    std::string base = std::to_string(idx);
    dump_grid(grid, c.ports, subc, "grid" + base + ".dat");
    write_dat("payload" + base + ".dat", payload);
    bool valid = res.message.get_status() == uci_status::valid;
    std::vector<uint8_t> ref_bits;
    for (auto b : res.message.get_harq_ack_bits()) ref_bits.push_back(b);
    for (auto b : res.message.get_sr_bits()) ref_bits.push_back(b);
    for (auto b : res.message.get_csi_part1_bits()) ref_bits.push_back(b);
    write_dat("ref_bits" + base + ".dat", ref_bits);

    m.begin_case();
    m.field("idx", (long long)idx);
    m.field("bwp_rb", (long long)c.bwp_rb);
    m.field("prb", (long long)c.prb);
    m.field("nof_prb", (long long)c.nof_prb);
    m.field("start_sym", (long long)c.start_sym);
    m.field("nof_syms", (long long)c.nof_syms);
    m.field("rnti", (long long)c.rnti);
    m.field("n_id", (long long)c.n_id);
    m.field("slot_idx", (long long)c.slot_idx);
    m.field("nof_harq", (long long)c.nof_harq);
    m.field("nof_sr", (long long)c.nof_sr);
    m.field("nof_csi1", (long long)c.nof_csi1);
    m.field("occ_length", (long long)c.occ_length);
    m.field("occ_index", (long long)c.occ_index);
    m.field("ports", (long long)c.ports);
    m.field("second_hop_prb", (long long)c.second_hop_prb);
    m.field("additional_dmrs", (long long)(c.additional_dmrs ? 1 : 0));
    m.field("pi2_bpsk", (long long)(c.pi2_bpsk ? 1 : 0));
    m.field("ref_valid", (long long)(valid ? 1 : 0));
    m.end_case();
    ++idx;
  }
  m.flush();
}

} // namespace

void gen_pucch_format0_suite() { gen_pucch_format0(); }
void gen_pucch_format1_suite() { gen_pucch_format1(); }
void gen_pucch_format2_suite() { gen_pucch_format2(); }
void gen_pucch_format34_suite() { gen_pucch_format34(); }
